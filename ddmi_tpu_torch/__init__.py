"""DDMI on PyTorch + CUDA: the port of `ddmi_tpu` to an NVIDIA Hopper card.

The package mirrors `ddmi_tpu/`'s layout (`nn/unet.py` <-> `nn/unet.py`, ...)
so each module sits where its JAX counterpart does.  Modules take the
reference PyTorch repo's `state_dict` names and layouts (NCHW convolutions,
head-major ADM `qkv`), so `ddmi_tpu/interop/reference_ckpt.py` maps a port
`state_dict` onto the JAX parameter tree and `interop.py` maps it back.

Plain tensor code is PyTorch; the TPU kernels on the ported paths (the
fused attention block, the fused image INR render, mha_vmem, the
flash-attention forward and backward, the fused NeRF MLP) are hand-written
CUDA C++ for `sm_90a` (`csrc/`: four libraries, `ops/build.py::LIBRARIES`;
mha_vmem and the fused block run the flash forward core), built with `nvcc`
on first use (`ops/build.py`).  On a CPU tensor each kernel wrapper runs its plain
PyTorch version instead.  The occupancy path's mesh extraction runs on the
host in `geometry/`, a copy of the JAX package's C++ core built with `g++`
on first use.  The entry points run on the card unless given
`device="cpu"`.

This package never imports JAX.
"""

__version__ = "0.1.0"
