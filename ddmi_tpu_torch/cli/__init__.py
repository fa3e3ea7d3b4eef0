"""ddmi_tpu_torch.cli: the port's command lines (main, precompute_fid)."""
