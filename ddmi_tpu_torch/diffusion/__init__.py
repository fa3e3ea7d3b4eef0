"""ddmi_tpu_torch.diffusion: see ddmi_tpu/diffusion for the JAX counterpart."""
