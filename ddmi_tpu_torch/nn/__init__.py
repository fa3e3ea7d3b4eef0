"""ddmi_tpu_torch.nn: see ddmi_tpu/nn for the JAX counterpart."""
