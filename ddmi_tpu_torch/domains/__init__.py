"""ddmi_tpu_torch.domains: see ddmi_tpu/domains for the JAX counterpart."""
