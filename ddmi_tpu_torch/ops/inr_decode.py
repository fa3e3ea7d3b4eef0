"""Fused INR render: the styled INRImage MLP per token tile in one kernel.

Counterpart of ddmi_tpu/ops/pallas/inr_decode.py.  The render's scale
injection si is one scalar, so the StyleGAN modulation/demodulation folds
into plain weights once per render (`fold_inr_image_params`, tensor code on
the module's device); the 13 matmuls then run per token in
csrc/inr_decode.cu on a CUDA tensor, or in `inr_decode_plain` on a CPU
tensor.  The weight slots follow the JAX kernel's tables:

  wa (14, CHP, CHP):  0 b2.conv1(h)  1 b2.conv2  2 b2.conv3  3 b2.skip(h)
                      4 b3.conv1(h)  5 b3.conv2  6 b3.conv3  7 b3.skip(h)
                      8 b4.conv1     9 b4.conv2 10 b4.conv3
                     11 b1.conv2    12 b1.conv3 13 torgb
  wb (6, INP0, CHP):  0 b1.conv1  1 b1.skip  2 b2.conv1(xm)  3 b2.skip(xm)
                      4 b3.conv1(xh)  5 b3.skip(xh)
  act_bias / noise_w: conv order b1c1..b1c3, b2c1.., b4c3.

NoiseInjection draws one N(0, 1) per token and conv from Philox4x32-10
keyed by (seed, token, conv) and Box-Muller (`philox_normal`), in the
kernel and, by default, in the plain version, so one seed gives the same
pixels on either device (up to float rounding of the Gaussians).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch
import torch.nn.functional as F

from ddmi_tpu_torch.ops import build
from ddmi_tpu_torch.ops.attention import needs_grad
from ddmi_tpu_torch.ops.resample import pixel_center_lin, separable_grid_sample

SQRT2 = math.sqrt(2.0)
INV_SQRT2 = 1.0 / SQRT2
LANE = 128
TILE = 128       # tokens per tile of the CUDA kernel (csrc/inr_decode.cu T)
KERNEL_CHP = 256
KERNEL_INP = 128
MAX_OUT_CH = 16
NCONV = 12
NOISE_KEY = 0x85EBCA6B  # Philox key word 1 of the noise stream (csrc/inr_decode.cu)
_MASK32 = 0xFFFFFFFF


def _pad128(n: int) -> int:
    return max(LANE, -(-n // LANE) * LANE)


@dataclasses.dataclass
class FoldedINR:
    """Style-folded INRImage weights, zero-padded for the kernel."""

    wa: torch.Tensor        # (14, CHP, CHP) compute dtype
    wb: torch.Tensor        # (6, INP0, CHP) compute dtype
    act_bias: torch.Tensor  # (12, CHP) fp32
    noise_w: torch.Tensor   # (12,) fp32
    rgb_bias: torch.Tensor  # (CHP,) fp32
    out_ch: int
    has_noise: bool


def _fold_mod_conv(conv, style: torch.Tensor, demodulate: bool) -> torch.Tensor:
    """ModulatedConv (k = 1) -> dense W_eff (in, out) in fp32."""
    w = conv.weight[0, :, :, 0, 0].float().t()  # (in, out)
    mod = conv.modulation
    s = style @ (mod.weight.float().t() * mod.scale) + mod.bias.float()
    w_eff = s[:, None] * (w * conv.scale)
    if demodulate:
        w_eff = w_eff * torch.rsqrt((w_eff**2).sum(0) + 1e-8)[None, :]
    return w_eff


@torch.no_grad()
def fold_inr_image_params(mlp, si, dtype=torch.bfloat16) -> FoldedINR:
    """Fold an INRImage (nn/inr.py) and one scale injection into kernel
    weights."""
    cfg = mlp.cfg
    ch, in0 = cfg.ch, cfg.latent_dim + cfg.in_ch
    INP0, CHP = _pad128(in0), _pad128(ch)
    dev = mlp.torgb.bias.device
    style = mlp.style(si, 1, dev)[0]

    def pad_to(w, rows, cols):
        out = torch.zeros((rows, cols), dtype=torch.float32, device=dev)
        out[: w.shape[0], : w.shape[1]] = w
        return out

    act_bias, noise_w = [], []

    def block(blk):
        ws = [_fold_mod_conv(getattr(blk, c).conv, style, True)
              for c in ("conv1", "conv2", "conv3")]
        for c in ("conv1", "conv2", "conv3"):
            act_bias.append(pad_to(getattr(blk, c).activate.bias.float()[None], 1, CHP)[0])
            noise_w.append(getattr(blk, c).noise.weight.float().reshape(()))
        skip = None
        if blk.skip is not None:
            eq = blk.skip[0]
            skip = eq.weight[:, :, 0, 0].float().t() * eq.scale
        return ws + [skip]

    b1, b2, b3, b4 = (block(getattr(mlp, f"net_res{i}")) for i in (1, 2, 3, 4))
    w_rgb = _fold_mod_conv(mlp.torgb.conv, style, False)
    wa = [
        pad_to(b2[0][:ch], CHP, CHP), pad_to(b2[1], CHP, CHP),
        pad_to(b2[2], CHP, CHP), pad_to(b2[3][:ch], CHP, CHP),
        pad_to(b3[0][:ch], CHP, CHP), pad_to(b3[1], CHP, CHP),
        pad_to(b3[2], CHP, CHP), pad_to(b3[3][:ch], CHP, CHP),
        pad_to(b4[0], CHP, CHP), pad_to(b4[1], CHP, CHP), pad_to(b4[2], CHP, CHP),
        pad_to(b1[1], CHP, CHP), pad_to(b1[2], CHP, CHP), pad_to(w_rgb, CHP, CHP),
    ]
    wb = [
        pad_to(b1[0], INP0, CHP), pad_to(b1[3], INP0, CHP),
        pad_to(b2[0][ch:], INP0, CHP), pad_to(b2[3][ch:], INP0, CHP),
        pad_to(b3[0][ch:], INP0, CHP), pad_to(b3[3][ch:], INP0, CHP),
    ]
    rgb_bias = torch.zeros(CHP, dtype=torch.float32, device=dev)
    rgb_bias[: cfg.out_ch] = mlp.torgb.bias.float().reshape(-1)
    nw = torch.stack(noise_w)
    return FoldedINR(
        wa=torch.stack(wa).to(dtype), wb=torch.stack(wb).to(dtype),
        act_bias=torch.stack(act_bias), noise_w=nw, rgb_bias=rgb_bias,
        out_ch=cfg.out_ch, has_noise=bool((nw != 0).any()),
    )


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m, for an int64 tensor `a` of 32-bit
    words and a 32-bit constant m, from 16-bit halves so that no int64
    product overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    ll, lh, hl = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = a_hi * m_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., Random123) on int64 tensors of 32-bit
    words: ctr four words, key two (tensors or ints); -> the four output
    words, the kernel's philox4x32_10 bit for bit."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
    return c0, c1, c2, c3


def philox_normal(seed: int, n_tokens: int, device=None) -> torch.Tensor:
    """The kernel's NoiseInjection draws, (n_tokens, 12) fp32: Philox4x32-10
    on the counter (token, conv, 0, 0) with the key (seed, NOISE_KEY), then
    Box-Muller on the first two words, u1 = ((w0 >> 8) + 1) / 2^24 in (0, 1]
    and u2 = (w1 >> 8) / 2^24, N = sqrt(-2 log u1) cos(2 pi u2), in fp32."""
    tok = torch.arange(n_tokens, dtype=torch.int64, device=device)[:, None].expand(-1, NCONV)
    conv = torch.arange(NCONV, dtype=torch.int64, device=device)[None, :].expand(n_tokens, -1)
    zero = torch.zeros_like(tok)
    w0, w1, _, _ = philox4x32_10((tok, conv, zero, zero), (int(seed) & _MASK32, NOISE_KEY))
    u1 = ((w0 >> 8) + 1).float() * (1.0 / 16777216.0)
    u2 = (w1 >> 8).float() * (1.0 / 16777216.0)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(6.28318530717958648 * u2)


def inr_decode_plain(folded: FoldedINR, x0, xm, xh, seed: int, noise=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: fp32 products of the
    compute-dtype operands, activations cast to the compute dtype where the
    kernel casts them.  Noise (when a gain is nonzero) is `noise`, (N, 12)
    N(0, 1) draws, or else the kernel's own: philox_normal(seed, N)."""
    cdt = x0.dtype
    wa, wb, ab = folded.wa.float(), folded.wb.float(), folded.act_bias
    gauss = None
    if folded.has_noise:
        if noise is None:
            noise = philox_normal(seed, x0.shape[0], device=x0.device)
        gauss = noise.to(x0.device, torch.float32) * folded.noise_w[None, :]

    def mm(x, w):
        return x.float() @ w

    def styled(pre, k):
        if gauss is not None:
            pre = pre + gauss[:, k : k + 1]
        return F.leaky_relu(pre + ab[k][None, :], 0.2) * SQRT2

    def resblock(h, extra, k0, wa1, wa2, wa3, was, wb1, wbs):
        a = mm(extra, wb[wb1]) if wb1 is not None else 0.0
        if wa1 is not None:
            a = a + mm(h, wa[wa1])
        a = styled(a, k0).to(cdt)
        a = styled(mm(a, wa[wa2]), k0 + 1).to(cdt)
        a = styled(mm(a, wa[wa3]), k0 + 2)
        if wbs is not None or was is not None:
            s = mm(extra, wb[wbs]) if wbs is not None else 0.0
            if was is not None:
                s = s + mm(h, wa[was])
        else:
            s = h.float()
        return ((a + s) * INV_SQRT2).to(cdt)

    h = resblock(None, x0, 0, None, 11, 12, None, 0, 1)
    h = resblock(h, xm, 3, 0, 1, 2, 3, 2, 3)
    h = resblock(h, xh, 6, 4, 5, 6, 7, 4, 5)
    h = resblock(h, None, 9, 8, 9, 10, None, None, None)
    out = mm(h, wa[13][:, : folded.out_ch]) + folded.rgb_bias[: folded.out_ch]
    return out.to(cdt)


def _lib():
    lib = build.load("inr_decode")
    fn = lib.ddmi_inr_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
            ctypes.c_uint, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(f: FoldedINR, x0, xm, xh):
    N = x0.shape[0]
    if N < 1:
        raise ValueError("inr_decode_fused needs at least one token")
    for x in (x0, xm, xh):
        if x.shape != (N, KERNEL_INP) or x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"tokens must be contiguous bf16 (N, {KERNEL_INP})")
        if x.data_ptr() % 16:
            raise ValueError("tokens must start on a 16-byte boundary (a TMA source)")
    expect = {
        "wa": (f.wa, (14, KERNEL_CHP, KERNEL_CHP), torch.bfloat16),
        "wb": (f.wb, (6, KERNEL_INP, KERNEL_CHP), torch.bfloat16),
        "act_bias": (f.act_bias, (12, KERNEL_CHP), torch.float32),
        "noise_w": (f.noise_w, (12,), torch.float32),
        "rgb_bias": (f.rgb_bias, (KERNEL_CHP,), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"folded.{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x0.device:
            raise ValueError(f"folded.{name} is not on the tokens' device")
    if not 1 <= f.out_ch <= MAX_OUT_CH:
        raise ValueError(f"out_ch {f.out_ch} outside [1, {MAX_OUT_CH}]")


def inr_decode_fused(folded: FoldedINR, x0, xm, xh, seed: int) -> torch.Tensor:
    """x0/xm/xh: (N, INP0) tokens [pe | si, zero-padded].  -> (N, out_ch).
    The kernel takes any N: its last tile reads zeros past N and stores no
    row there."""
    if x0.device.type == "cpu":
        return inr_decode_plain(folded, x0, xm, xh, seed)
    if x0.device.type != "cuda":
        raise ValueError(f"inr_decode_fused: unsupported device {x0.device}")
    if needs_grad(x0, xm, xh, folded.wa, folded.wb, folded.act_bias, folded.noise_w,
                  folded.rgb_bias):
        raise RuntimeError("inr_decode_fused has no gradient (nor has the JAX kernel): "
                           "call it under torch.no_grad() or torch.inference_mode()")
    _check_cuda_operands(folded, x0, xm, xh)
    N = x0.shape[0]
    out = torch.empty((N, folded.out_ch), dtype=torch.bfloat16, device=x0.device)
    err = _lib().ddmi_inr_decode(
        x0.data_ptr(), xm.data_ptr(), xh.data_ptr(), folded.wa.data_ptr(),
        folded.wb.data_ptr(), folded.act_bias.data_ptr(), folded.noise_w.data_ptr(),
        folded.rgb_bias.data_ptr(), out.data_ptr(), N, folded.out_ch,
        int(folded.has_noise), int(seed) & _MASK32,
        torch.cuda.current_stream(x0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"INR decode kernel launch failed: cudaError {err}")
    inr_decode_fused.launches += 1
    return out


inr_decode_fused.launches = 0


def render_tokens(hdbf, res: int, si, in_ch: int):
    """The kernel's three token sets for a regular res x res pixel-centre
    grid: (b * res * res, INP0) each, y-major, [pe | si * in_ch | zeros]."""
    b, latent = hdbf[0].shape[0], hdbf[0].shape[1]
    dtype = hdbf[0].dtype
    lin = pixel_center_lin(res, device=hdbf[0].device).to(dtype)
    n = res * res
    in0 = latent + in_ch
    INP0 = _pad128(in0)

    def tokens(plane):
        t = separable_grid_sample(plane, lin, lin, align_corners=False,
                                  padding_mode="border").reshape(b * n, latent)
        t = torch.cat([t, torch.full((b * n, in_ch), float(si), dtype=dtype,
                                     device=t.device)], dim=-1)
        return F.pad(t, (0, INP0 - in0)).contiguous()

    return tokens(hdbf[0]), tokens(hdbf[1]), tokens(hdbf[2])


@torch.no_grad()
def render_tokens_fused(mlp, hdbf, res: int, si, seed: int) -> torch.Tensor:
    """Regular res x res render of a 3-level HDBF pyramid (NCHW planes) ->
    (b, res * res, out_ch).  PE sampling stays as two interpolation
    products per plane; the styled MLP runs in `inr_decode_fused`."""
    b = hdbf[0].shape[0]
    folded = fold_inr_image_params(mlp, si, dtype=hdbf[0].dtype)
    x0, xm, xh = render_tokens(hdbf, res, si, mlp.cfg.in_ch)
    out = inr_decode_fused(folded, x0, xm, xh, seed)
    return out.reshape(b, res * res, folded.out_ch)
