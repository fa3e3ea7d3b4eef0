"""Fused NeRF MLP: the whole INRNeRF per point tile in one kernel.

Counterpart of ddmi_tpu/ops/pallas/nerf_mlp.py.  `fold_nerf_params` splits
and pads an INRNeRF (nn/inr.py) into the JAX kernel's layout, with the same
arrays as the JAX fold (bf16 by default, biases rounded too):

  wx (D, XP, W)  xyz-side kernels, rows [0, in_xyz) live, zero for layers
                 that take no xyz input; XP = in_xyz padded to 128
  wh (D, W, W)   h-side kernels (zero for layer 0);  b (D, 1, W)
  w_sig (W, 128), b_sig (1, 128)      sigma head, column 0 live
  w_fin (W, W), b_fin (1, W)          xyz_encoding_final
  w_dirf (W, 128), w_dird (DP, 128), b_dir (1, 128)   dir_encoding split at
                 the [feat | dir] concat; DP = in_dir padded to 128
  w_rgb (128, 128), b_rgb (1, 128)    rgb head, columns 0..2 live

On a CUDA tensor `nerf_mlp_fused` launches csrc/nerf_mlp.cu, which reads x
(N, in_xyz + in_dir) without the TPU's lane padding and streams the folded
weights through a TMA ring (128-point tiles, wgmma); on a CPU tensor it runs
`nerf_mlp_plain`, the same arithmetic in PyTorch.  The kernel's predicate is
the JAX one: width 256, so that the dir head is 128 wide (W // 2 == LANE),
at any input width.  The CUDA kernel keeps a tile's inputs in shared memory
in 64-column panels while they fill at most 8 of them together
(in_xyz + in_dir up to about 512; srn_cars: 159 and 27 in 4); wider inputs
stream through a buffer of four panels a chunk at a time (the kernel's
CHUNKED instance).  `kernel_supported` is the JAX predicate with both input
widths at least 1, and NeRFPipeline runs the INRNeRF module where it is
false.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from ddmi_tpu_torch.ops import build
from ddmi_tpu_torch.ops.attention import needs_grad

LANE = 128
SLOPE = 0.01


def _pad_to(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def supported(width: int) -> bool:
    """The JAX kernel's predicate (fold_nerf_params, _fused_mlp_gate):
    W % 128 == 0 and W // 2 == 128, i.e. W == 256."""
    return width % LANE == 0 and width // 2 == LANE


def kernel_supported(width: int, in_xyz: int, in_dir: int) -> bool:
    """`supported`, with at least one xyz and one dir input column (the
    CUDA kernel takes any input width: see the module's docstring)."""
    return supported(width) and in_xyz >= 1 and in_dir >= 1


@dataclasses.dataclass
class FoldedNeRF:
    wx: torch.Tensor
    wh: torch.Tensor
    b: torch.Tensor
    w_sig: torch.Tensor
    b_sig: torch.Tensor
    w_fin: torch.Tensor
    b_fin: torch.Tensor
    w_dirf: torch.Tensor
    w_dird: torch.Tensor
    b_dir: torch.Tensor
    w_rgb: torch.Tensor
    b_rgb: torch.Tensor
    depth: int
    width: int
    in_xyz: int
    in_dir: int
    skips: Tuple[int, ...]

    def tensors(self):
        return (self.wx, self.wh, self.b, self.w_sig, self.b_sig, self.w_fin, self.b_fin,
                self.w_dirf, self.w_dird, self.b_dir, self.w_rgb, self.b_rgb)


@torch.no_grad()
def fold_nerf_params(mlp, dtype: torch.dtype = torch.bfloat16) -> FoldedNeRF:
    """INRNeRF -> the kernel layout in `dtype` (bf16: the JAX fold's arrays,
    bit for bit).  Raises NotImplementedError outside the predicate."""
    D, W = mlp.depth, mlp.width
    in_xyz, in_dir, skips = mlp.in_channels_xyz, mlp.in_channels_dir, mlp.skips
    if not supported(W):
        raise NotImplementedError(f"the NeRF MLP kernel takes width {2 * LANE}, not {W}")
    XP, DP = _pad_to(in_xyz, LANE), _pad_to(in_dir, LANE)
    dev = mlp.sigma.weight.device
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)

    def dense(lin):  # torch Linear -> (in, out) kernel and bias: copies in dtype
        return lin.weight.detach().t().to(dtype, copy=True), lin.bias.detach().to(dtype, copy=True)

    wx, wh, b = zeros(D, XP, W), zeros(D, W, W), zeros(D, 1, W)
    for i in range(D):
        kern, bias = dense(getattr(mlp, f"xyz_encoding_{i + 1}")[0])
        b[i, 0] = bias
        if i == 0:
            if i in skips or kern.shape[0] != in_xyz:
                raise NotImplementedError("the kernel takes no skip at layer 0")
            wx[i, :in_xyz] = kern
        elif i in skips:
            wx[i, :in_xyz] = kern[:in_xyz]
            wh[i] = kern[in_xyz:]
        else:
            wh[i] = kern
    ks, bs = dense(mlp.sigma)
    w_sig, b_sig = zeros(W, LANE), zeros(1, LANE)
    w_sig[:, :1], b_sig[0, :1] = ks, bs
    kf, bfin = dense(mlp.xyz_encoding_final)
    kd, bd = dense(mlp.dir_encoding[0])
    w_dird = zeros(DP, LANE)
    w_dird[:in_dir] = kd[W:]
    kr, br = dense(mlp.rgb[0])
    w_rgb, b_rgb = zeros(LANE, LANE), zeros(1, LANE)
    w_rgb[:, :3], b_rgb[0, :3] = kr, br
    return FoldedNeRF(
        wx=wx, wh=wh, b=b, w_sig=w_sig, b_sig=b_sig,
        w_fin=kf.contiguous(), b_fin=bfin.reshape(1, W).contiguous(),
        w_dirf=kd[:W].contiguous(), w_dird=w_dird, b_dir=bd.reshape(1, LANE).contiguous(),
        w_rgb=w_rgb, b_rgb=b_rgb, depth=D, width=W, in_xyz=in_xyz, in_dir=in_dir,
        skips=tuple(skips),
    )


def nerf_mlp_plain(folded: FoldedNeRF, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 products of operands in
    the folded dtype, h / feat / d rounded to it where the kernel rounds
    them.  x (N, in_xyz + in_dir) -> (N, 4) fp32 [sigmoid(rgb), sigma]."""
    f = folded
    cdt = f.wh.dtype
    x = x.to(cdt)
    xp, dp = x[:, : f.in_xyz].float(), x[:, f.in_xyz :].float()
    leaky = lambda a: torch.where(a > 0, a, SLOPE * a)
    h = None
    for i in range(f.depth):
        acc = f.b[i].float()
        if i == 0 or i in f.skips:
            acc = acc + xp @ f.wx[i, : f.in_xyz].float()
        if i > 0:
            acc = acc + h.float() @ f.wh[i].float()
        h = leaky(acc).to(cdt)
    hf = h.float()
    sigma = hf @ f.w_sig[:, :1].float() + f.b_sig[:, :1].float()
    feat = (hf @ f.w_fin.float() + f.b_fin.float()).to(cdt)
    d = feat.float() @ f.w_dirf.float() + dp @ f.w_dird[: f.in_dir].float() + f.b_dir.float()
    d = leaky(d).to(cdt)
    rgb = torch.sigmoid(d.float() @ f.w_rgb[:, :3].float() + f.b_rgb[:, :3].float())
    return torch.cat([rgb, sigma], dim=-1)


def _lib():
    lib = build.load("nerf_mlp")
    fn = lib.ddmi_nerf_mlp
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
            ctypes.c_uint, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(f: FoldedNeRF, x: torch.Tensor) -> None:
    if not supported(f.width):
        raise NotImplementedError(f"the NeRF MLP kernel takes width {2 * LANE}, not {f.width}")
    if not 1 <= f.depth <= 32 or any(not 0 < s < f.depth for s in f.skips):
        raise NotImplementedError(f"depth {f.depth} / skips {f.skips}")
    C = f.in_xyz + f.in_dir
    if not kernel_supported(f.width, f.in_xyz, f.in_dir):
        raise NotImplementedError(f"the NeRF MLP kernel takes in_xyz and in_dir of at least 1, "
                                  f"not {f.in_xyz} and {f.in_dir}")
    if (x.ndim != 2 or x.shape[1] != C or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or x.data_ptr() % 4):
        raise ValueError(f"x must be contiguous, 4-byte aligned bf16 (N, {C}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    D, W, XP, DP = f.depth, f.width, _pad_to(f.in_xyz, LANE), _pad_to(f.in_dir, LANE)
    shapes = [(D, XP, W), (D, W, W), (D, 1, W), (W, LANE), (1, LANE), (W, W), (1, W),
              (W, LANE), (DP, LANE), (1, LANE), (LANE, LANE), (1, LANE)]
    for t, shape in zip(f.tensors(), shapes):
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"folded weight: want contiguous bf16 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("the folded weights are not on x's device")


def nerf_mlp_fused(folded: FoldedNeRF, x: torch.Tensor) -> torch.Tensor:
    """x (N, in_xyz + in_dir) -> (N, 4) fp32 [sigmoid(rgb), sigma]."""
    if x.device.type == "cpu":
        return nerf_mlp_plain(folded, x)
    if x.device.type != "cuda":
        raise ValueError(f"nerf_mlp_fused: unsupported device {x.device}")
    if needs_grad(x, *folded.tensors()):
        raise RuntimeError("nerf_mlp_fused has no gradient (nor has the JAX kernel): "
                           "call it under torch.no_grad() or torch.inference_mode()")
    _check_cuda_operands(folded, x)
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    in_xyz, in_dir = folded.in_xyz, folded.in_dir
    if (in_xyz + in_dir) % 2:
        # the kernel reads x in bf16 pairs: give the odd side a zero column,
        # which meets a zero row of the fold's padding (XP, DP are even) and
        # stays in the same 64-column panel
        zero = x.new_zeros((N, 1))
        if in_xyz % 2:
            x, in_xyz = torch.cat([x[:, :in_xyz], zero, x[:, in_xyz:]], 1), in_xyz + 1
        else:
            x, in_dir = torch.cat([x, zero], 1), in_dir + 1
    skip_mask = sum(1 << s for s in set(folded.skips))
    err = _lib().ddmi_nerf_mlp(
        x.data_ptr(), *(t.data_ptr() for t in folded.tensors()), out.data_ptr(),
        N, in_xyz, in_dir, folded.wx.shape[1], folded.w_dird.shape[0], folded.depth, skip_mask,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"NeRF MLP kernel launch failed: cudaError {err}")
    nerf_mlp_fused.launches += 1
    return out


nerf_mlp_fused.launches = 0
