"""ddmi_tpu_torch.core: see ddmi_tpu/core for the JAX counterpart."""
