"""ddmi_tpu_torch.data: see ddmi_tpu/data for the JAX counterpart."""
