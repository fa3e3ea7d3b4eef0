"""ddmi_tpu_torch.ops: see ddmi_tpu/ops for the JAX counterpart."""
