"""The PyTorch port's metric networks against the JAX package's, on the CPU:
the FID InceptionV3 and the FVD I3D on shared random weights (the port's
He-normal draws with randomised frozen BatchNorm statistics, carried to
JAX by its own converters, ddmi_tpu/evals/{inception,i3d}.py::load_torch_*),
the reverse weight maps of ddmi_tpu_torch/interop.py, and the plain
bilinear resize against jax.image.resize.

Tolerances: network outputs within 1e-4 of max|ref| (fp32 convolutions
summed in other orders); the resize within 1e-5 absolutely on [0, 1]
images; weight maps bit-exact both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu.evals.i3d import I3D as JaxI3D, load_torch_i3d
from ddmi_tpu.evals.inception import InceptionV3 as JaxInception, load_torch_inception
from ddmi_tpu_torch.evals.i3d import I3D
from ddmi_tpu_torch.evals.inception import InceptionV3
from ddmi_tpu_torch.interop import i3d_from_jax, inception_from_jax

torch.set_num_threads(4)


def _randomize_bn(net, seed):
    """Non-trivial frozen BatchNorm statistics and affine terms, so that a
    swapped mean / var / scale / bias would show."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                m.running_mean.normal_(0.0, 0.05, generator=g)
                m.running_var.uniform_(0.8, 1.2, generator=g)
                m.weight.uniform_(0.9, 1.1, generator=g)
                m.bias.normal_(0.0, 0.05, generator=g)
    return net


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1e-3, np.abs(ref).max()))


def _same_tree(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (pa, x), (_, y) in zip(fa, fb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), pa


@pytest.fixture(scope="module")
def inception():
    """The port's InceptionV3, its JAX twin's params, and both nets' (pool,
    logits) on one 299^2 image (one JAX forward for the module)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = _randomize_bn(InceptionV3(), 1)
    params = load_torch_inception(net.state_dict())
    x = np.random.default_rng(2).random((1, 299, 299, 3)).astype(np.float32)
    with torch.inference_mode():
        got = [t.numpy() for t in net(torch.from_numpy(x))]
    ref = [np.asarray(t) for t in jax.jit(lambda p, a: JaxInception().apply({"params": p}, a))(
        params, jnp.asarray(x))]
    return net, params, got, ref


@pytest.mark.parametrize("out", ["pool", "logits"])
def test_inception_matches_jax(inception, out):
    """Pool features (2048) and logits (1008) of a 299^2 image against the
    JAX InceptionV3 on the same weights, within 1e-4 of max|ref|: the FID
    blocks' average pools that leave the padding out of the count, the
    last block's max pool, the frozen BatchNorm (eps 1e-3)."""
    _, _, got, ref = inception
    i = ["pool", "logits"].index(out)
    assert got[i].shape == ref[i].shape == (1, (2048, 1008)[i])
    assert _rel(got[i], ref[i]) < 1e-4, _rel(got[i], ref[i])
    assert np.abs(ref[i]).max() > 1e-3  # the features did not fade to zero


def test_inception_weight_maps_round_trip(inception):
    """interop.inception_from_jax is the exact inverse of the JAX package's
    load_torch_inception, both ways."""
    net, params, _, _ = inception
    sd = net.state_dict()
    back = inception_from_jax(params)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    _same_tree(load_torch_inception(back), params)


@pytest.fixture(scope="module")
def i3d():
    """The port's I3D, its JAX twin's params, and both nets' logits on the
    shortest clip the network takes at 224^2: 9 frames (the temporal
    strides 2, 2 and 2 then leave the final (2, 7, 7) average pool 2
    frames)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        net = _randomize_bn(I3D(), 4)
    params = load_torch_i3d(net.state_dict())
    x = np.random.default_rng(5).uniform(-1, 1, (1, 9, 224, 224, 3)).astype(np.float32)
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(lambda p, a: JaxI3D().apply({"params": p}, a))(params,
                                                                          jnp.asarray(x)))
    return net, params, got, ref


def test_i3d_matches_jax(i3d):
    """The 400 logits of a 9-frame clip against the JAX I3D on the same
    weights, within 1e-4 of max|ref|: TF-style SAME padding of every
    convolution (zeros) and max pool (-inf), the frozen BatchNorm (eps
    1e-5), the biased logits conv."""
    _, _, got, ref = i3d
    assert got.shape == ref.shape == (1, 400)
    assert _rel(got, ref) < 1e-4, _rel(got, ref)
    assert np.abs(ref).max() > 1e-3


def test_i3d_weight_maps_round_trip(i3d):
    """interop.i3d_from_jax is the exact inverse of load_torch_i3d, both
    ways (the Mixed blocks' `Branch_1/Conv3d_0b_3x3` is pytorch_i3d's
    `b1b`)."""
    net, params, _, _ = i3d
    sd = net.state_dict()
    back = i3d_from_jax(params)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    _same_tree(load_torch_i3d(back), params)


@pytest.mark.parametrize("shape,size", [
    ((2, 48, 64, 3), (299, 299)),       # up: InceptionV3's resize of small images
    ((1, 3, 256, 256, 3), (224, 224)),  # down, antialiased: FVD's clips
    ((2, 300, 310, 3), (299, 299)),     # down by a hair on both axes
    ((2, 17, 9, 3), (8, 20)),           # down on H, up on W
])
def test_resize_matches_jax_image_resize(shape, size):
    """core/coords.py::resize_bilinear against jax.image.resize(...,
    "bilinear") (antialiased where an axis shrinks), within 1e-5; torch's
    interpolate(antialias=True) is not the same function."""
    from ddmi_tpu_torch.core.coords import resize_bilinear

    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape[:-3] + size + shape[-1:],
                                      "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5, np.abs(got - ref).max()
