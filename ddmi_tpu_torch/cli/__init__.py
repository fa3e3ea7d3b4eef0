"""ddmi_tpu_torch.cli: the port's command lines (main, precompute_fid,
serve, convert_reference_ckpt)."""
