"""The benchmark of the PyTorch port (`ddmi_tpu_torch`) on one H100: see
run.py and BENCHMARK.json at the root of the repository."""
