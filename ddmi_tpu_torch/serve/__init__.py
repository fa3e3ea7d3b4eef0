"""ddmi_tpu_torch.serve: see ddmi_tpu/serve for the JAX counterpart."""
