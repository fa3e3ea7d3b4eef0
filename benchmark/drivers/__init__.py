"""Traffic drivers, found by a traffic file's `driver`."""
