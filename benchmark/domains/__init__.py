"""Per-domain adapters, found by a configuration's `domain`: what the
service is built with, the spans of its pipeline, the plain reference of a
served request, and the work a sample takes."""
