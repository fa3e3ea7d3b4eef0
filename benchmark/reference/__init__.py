"""The benchmark's plain reference of DDMI sampling: plain PyTorch, float32
with TF32 off, independent of the package under test.  It imports nothing
of that package; a test holds it to the package at small widths on the
CPU, and every benchmark run holds the package's served outputs to it."""
