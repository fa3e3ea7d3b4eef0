"""The port's attention kernels through their plain PyTorch versions (what a
wrapper runs on a CPU tensor), against the JAX package on the same
numpy-made inputs:

* `mha_plain` against the Pallas `mha_vmem` in interpret mode, including
  n < 64 and n % 64 != 0, where the CUDA kernel's 64-row q tile is ragged;
* `flash_plain` against the JAX chunked attention (ops/mea.py) and a dense
  reference (the library Pallas flash kernel has no CPU mode; all three
  compute exact attention);
* the widened `attention_block_plain` against `fused_attention_block` in
  interpret mode at head dim 64 with n 8...128 (the triplane UNet's shapes);
* the port's MEA path and `tiered_attention` against the JAX ones, and the
  gates against the JAX predicates;
* the wrappers' shape logic: the kernel instance a head dim runs on, the
  zero-padding helper, and that padded operands cut back give the unpadded
  result (exactly) through both plain versions.

The CUDA kernels themselves are tested on the card in
tests/test_torch_cuda.py.  Tolerance: max|diff| <= 1e-4 * max(1, max|ref|),
fp32 on both sides, sums in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.ops import mea as jax_mea
from ddmi_tpu.ops.pallas import attention as jax_vmem
from ddmi_tpu.ops.pallas import attn_block as jax_block
from ddmi_tpu_torch.ops import attention, attn_block, flash_attention, mea

torch.set_num_threads(1)


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _qkv(seed, *shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _dense(q, k, v, scale):
    s = np.einsum("bhnd,bhmd->bhnm", q.astype(np.float64), k) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhnm,bhmd->bhnd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("hd", [16, 32, 64, 96])
@pytest.mark.parametrize("n", [8, 32, 128, 512])
def test_mha_plain_matches_pallas_interpret(n, hd):
    q, k, v = _qkv(n + hd, 1, 2, n, hd)
    scale = hd**-0.5
    ref = jax_vmem.mha_vmem(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True)
    got = attention.mha_vmem(*map(torch.from_numpy, (q, k, v)), scale)
    _close(got, ref, "vs pallas interpret")
    _close(got, _dense(q, k, v, scale), "vs dense")


def test_mha_plain_rounds_q_once_after_scaling():
    """In bf16, q * scale is taken in fp32 and rounded once, as the TPU
    kernel does; the rest of the plain version is fp32."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(5, 1, 1, 16, 32))
    scale = 0.3
    qs = (q.float() * scale).bfloat16().float()
    ref = torch.softmax(qs @ k.float().transpose(-1, -2), -1) @ v.float()
    assert torch.equal(attention.mha_plain(q, k, v, scale), ref.bfloat16())


@pytest.mark.parametrize("n", [2048, 2560])
def test_flash_plain_matches_jax_chunked_attention(n):
    q, k, v = _qkv(n, 1, 2, n, 32)
    scale = 32**-0.5
    ref = jax_mea.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention.flash_plain(*map(torch.from_numpy, (q, k, v)), scale)
    _close(got, ref, "vs jax mea")
    _close(got, _dense(q, k, v, scale), "vs dense")


@pytest.mark.parametrize("H,W", [(2, 4), (4, 4), (4, 8), (8, 16)])
def test_attention_block_plain_matches_pallas_at_head_dim_64(H, W):
    rng = np.random.default_rng(H * W)
    B, C, nh = 2, 128, 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    args = (f(B, H, W, C), 1.0 + 0.1 * f(C), 0.1 * f(C), f(C, 3 * C) / np.sqrt(C),
            0.1 * f(3 * C), f(C, C) / np.sqrt(C), 0.1 * f(C))
    scale = 64**-0.5
    got = attn_block.fused_attention_block(*map(torch.from_numpy, args), nh, scale)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jax_block.fused_attention_block(*jargs, nh, scale, 32, 1e-5, True),
           "vs pallas interpret")
    _close(got, jax_block._dense_block_ref(*jargs, nh, scale), "vs dense ref")


@pytest.mark.parametrize("n,d", [(1024, 64), (2560, 32)])
def test_mea_matches_jax(n, d):
    q, k, v = _qkv(d, 2, 2, n, d)
    ref = jax_mea.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = mea.attention(*map(torch.from_numpy, (q, k, v)))
    _close(got, ref, "mea")


@pytest.mark.parametrize("n,hd", [(40, 16), (2048, 16), (1536, 8), (3072, 32)])
def test_tiered_attention_matches_jax(n, hd):
    from ddmi_tpu.nn.attention1d import tiered_attention as jax_tiered
    from ddmi_tpu_torch.nn.attention1d import tiered_attention

    q, k, v = _qkv(n, 1, 2, n, hd)
    ref = jax_tiered(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tiered_attention(*map(torch.from_numpy, (q, k, v)))
    _close(got, ref, "tiered")


def test_gates_match_the_jax_predicates():
    for n in (8, 16, 36, 48, 64, 512, 1024, 1032, 2048):
        for hd in (8, 16, 24, 32, 64, 96, 128, 160):
            assert attention.supported(n, hd) == jax_vmem.supported(n, hd), (n, hd)
            for nh in (1, 2, 4, 8, 16):
                C = nh * hd
                assert attn_block.jax_supported(n, C, nh) == jax_block.supported(n, C, nh)
                assert attn_block.supported(n, C, nh) == jax_block.supported(n, C, nh)
    # the flash gate of ddmi_tpu/nn/attention1d.py::tiered_attention
    assert flash_attention.supported(2048, 16) and flash_attention.supported(73728, 64)
    assert flash_attention.supported(20480, 128) and flash_attention.supported(512, 32)
    assert not flash_attention.supported(6144, 256) and not flash_attention.supported(1536, 32)
    assert not flash_attention.supported(256, 32) and not flash_attention.supported(4096, 96)


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain path only for a CPU tensor."""
    x = torch.zeros((1, 2, 64, 32), device="meta")
    for fn in (attention.mha_vmem, flash_attention.flash_attention):
        with pytest.raises(ValueError):
            fn(x, x, x, 0.1)


@pytest.mark.parametrize("hd,flash_hd,mha_hd", [
    (1, 16, 16), (8, 16, 16), (16, 16, 16), (17, 32, 32), (24, 32, 32), (32, 32, 32),
    (48, 64, 64), (64, 64, 64), (80, 128, 128), (96, 128, 128), (112, 128, 128),
    (128, 128, 128)])
def test_instance_choice(hd, flash_hd, mha_hd):
    """flash runs on the smallest of its instances (16, 32, 64, 128) that
    holds hd; mha_vmem runs on the same flash core and instance."""
    assert flash_attention.instance_hd(hd) == flash_hd
    assert attention.mha_head_dim(hd) == mha_hd


def test_no_instance_above_128():
    with pytest.raises(NotImplementedError):
        flash_attention.instance_hd(129)


def test_pad_head_dim():
    t = torch.randn(2, 3, 5, 24)
    assert attention.pad_head_dim(t, 24) is t
    p = attention.pad_head_dim(t, 32)
    assert p.shape == (2, 3, 5, 32) and p.is_contiguous()
    assert torch.equal(p[..., :24], t) and not p[..., 24:].any()


@pytest.mark.parametrize("hd", [8, 24, 48, 96, 112])
@pytest.mark.parametrize("which", ["flash", "mha"])
def test_padded_operands_give_the_unpadded_result(which, hd):
    """Zero-padding q, k, v to the head dim the wrapper pads to (the next
    flash instance, for mha_vmem where hd is not a multiple of 8; the
    kernel's TMA zero fill pads the others the same way) and cutting the
    output back is exact: the zero columns add nothing to q.k and give zero
    output columns."""
    plain = {"flash": flash_attention.flash_plain, "mha": attention.mha_plain}[which]
    q, k, v = map(torch.from_numpy, _qkv(hd, 1, 2, 96, hd))
    scale = hd**-0.5
    hp = {"flash": flash_attention.instance_hd, "mha": attention.mha_head_dim}[which](hd)
    got = plain(*(attention.pad_head_dim(t, hp) for t in (q, k, v)), scale)
    assert got.shape[-1] == hp and not got[..., hd:].any()
    assert torch.equal(got[..., :hd], plain(q, k, v, scale))
