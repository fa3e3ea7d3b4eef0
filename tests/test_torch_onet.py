"""The standalone ConvONet in the port against the JAX package on the CPU,
on the same weights (converted by ddmi_tpu_torch/interop.py) and the same
numpy batches: the LocalDecoder on planes and a grid volume, the
pointnet's shared plane UNet, the voxel encoder (its planes at the grid's
resolution and resized up and down, its UNet2D, the 'grid' volume through
a UNet3D), ONetPipeline's loss and parameters over 3 Adam steps against
optax, `eval_iou`, `mesh_eval_fn`'s logits and a mesh from them, the
registry's refusal of an unknown encoder, and the occupancy pipeline's
voxel branch.

Tolerances: modules fp32 on both sides, max|diff| <= 1e-5 * max(1,
max|ref|); ONetPipeline's loss and parameters after 3 steps <= 1e-4 *
max(1, max|ref|) (Adam divides by the root of the second moment, so a
gradient's rounding moves an update by more than its own size); the IoU
exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddmi_tpu_torch import interop

torch.set_num_threads(1)


def _close(got, ref, what="", rel=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (what, err, tol)


def _random(tree_shapes, seed):
    """Seeded values of the shapes of a flax tree (jax.eval_shape): kernels
    N(0, 1 / fan_in), biases N(0, 0.05^2), every leaf nonzero."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        if str(path[-1].key) == "kernel":
            return (x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))).astype(np.float32)
        return (0.05 * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree_shapes)


def _batch(seed, b=2, n_cloud=96, n_points=64, voxels=None):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.55, 0.55, (b, n_points, 3)).astype(np.float32)
    occ = (np.linalg.norm(pts, axis=-1) < 0.35).astype(np.float32)
    if voxels:
        inputs = (rng.uniform(size=(b, voxels, voxels, voxels)) > 0.6).astype(np.float32)
    else:
        d = rng.standard_normal((b, n_cloud, 3)).astype(np.float32)
        inputs = 0.35 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {"points": pts, "occ": occ, "inputs": inputs}


def _pipelines(encoder, ek, dk, seed=0):
    """The JAX ONetPipeline with seeded random parameters and the port's
    with the same ones."""
    from ddmi_tpu.domains.onet import ONetPipeline as JaxPipe
    from ddmi_tpu_torch.domains.onet import ONetPipeline

    jpipe = JaxPipe(c_dim=8, encoder=encoder, encoder_kwargs=ek, decoder_kwargs=dk, lr=1e-3)
    batch = _batch(seed, voxels=8 if encoder == "voxel_simple_local" else None)
    shapes = jax.eval_shape(lambda: jpipe.init(jax.random.PRNGKey(0), batch).params)
    params = _random(shapes, seed + 1)
    if encoder == "voxel_simple_local":
        enc = interop.voxel_encoder_from_jax(params["encoder"], ek.get("unet_depth", 4))
    elif ek.get("unet"):
        enc = interop.pointnet_unet_from_jax(params["encoder"], ek["n_blocks"], ek["unet_depth"])
    else:
        enc = interop.pointnet_from_jax(params["encoder"], ek["n_blocks"])
    pipe = ONetPipeline(c_dim=8, encoder=encoder, encoder_kwargs=ek, decoder_kwargs=dk, lr=1e-3,
                        device="cpu")
    pipe.model.load_state_dict(interop.conv_onet_from_jax(params, enc, dk["n_blocks"]))
    return jpipe, params, pipe, batch


POINT_EK = dict(hidden_dim=16, plane_resolution=8, n_blocks=2, unet=True, unet_depth=2,
                unet_start_filts=4)
DK = dict(hidden_size=16, n_blocks=2)


def test_local_decoder_matches_jax_on_planes_and_a_grid():
    from ddmi_tpu.nn.onet import LocalDecoder as J
    from ddmi_tpu.nn.onet import normalize_3d_coordinate as jnorm
    from ddmi_tpu_torch.nn.onet import LocalDecoder, normalize_3d_coordinate

    rng = np.random.default_rng(0)
    p = rng.uniform(-0.6, 0.6, (2, 50, 3)).astype(np.float32)
    planes = {k: rng.standard_normal((2, 8, 8, 6)).astype(np.float32) for k in ("xz", "xy", "yz")}
    planes["grid"] = rng.standard_normal((2, 4, 5, 6, 6)).astype(np.float32)
    _close(normalize_3d_coordinate(torch.from_numpy(p), 0.1), jnorm(jnp.asarray(p), 0.1), "norm")
    for leaky in (False, True):
        jm = J(c_dim=6, hidden_size=16, n_blocks=3, leaky=leaky)
        jp = {k: jnp.asarray(v) for k, v in planes.items()}
        params = _random(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(p), jp)
                         ["params"], 2)
        tm = LocalDecoder(c_dim=6, hidden_size=16, n_blocks=3, leaky=leaky)
        tm.load_state_dict(interop.local_decoder_from_jax(params, 3))
        tp = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in planes.items()
              if k != "grid"}
        tp["grid"] = torch.from_numpy(planes["grid"]).permute(0, 4, 1, 2, 3)
        with torch.no_grad():
            got = tm(torch.from_numpy(p), tp)
        _close(got, jm.apply({"params": params}, jnp.asarray(p), jp), f"LocalDecoder {leaky}")
    with pytest.raises(TypeError):
        tm(torch.from_numpy(p), (torch.zeros(2, 50, 3), torch.zeros(2, 50, 6)))


def test_pointnet_unet_matches_jax():
    """LocalPoolPointnet(unet=True): one UNet2D, its weights shared by the
    three planes (the config reader's unet_kwargs)."""
    from ddmi_tpu.core.convocc_config import pointnet_kwargs as jkw
    from ddmi_tpu.nn.pointnet import LocalPoolPointnet as J
    from ddmi_tpu_torch.core.convocc_config import pointnet_kwargs
    from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet

    conv = {"model": {"c_dim": 8, "encoder_kwargs": {
        "hidden_dim": 16, "plane_resolution": 8, "n_blocks": 2, "unet": True,
        "unet_kwargs": {"depth": 3, "start_filts": 4}}}}
    assert pointnet_kwargs(conv) == jkw(conv)
    cloud = _batch(3)["inputs"]
    jm = J(**jkw(conv))
    params = _random(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(cloud))
                     ["params"], 4)
    ref = jm.apply({"params": params}, jnp.asarray(cloud))
    tm = LocalPoolPointnet(**pointnet_kwargs(conv))
    tm.load_state_dict(interop.pointnet_unet_from_jax(params, 2, 3))
    with torch.no_grad():
        got = tm(torch.from_numpy(cloud))
    for k in ("xz", "xy", "yz"):
        _close(got[k].permute(0, 2, 3, 1), ref[k], k)


@pytest.mark.parametrize("reso, unet, grid", [(8, False, False), (16, True, False),
                                               (4, False, True), (8, True, True)])
def test_voxel_encoder_matches_jax(reso, unet, grid):
    """The planes at the grid's resolution and resized up (16) and down (4,
    jax.image.resize's antialias), with the UNet2D, and the 'grid' volume
    through the UNet3D."""
    from ddmi_tpu.core.convocc_config import voxel_encoder_kwargs as jkw
    from ddmi_tpu.nn.pointnet import LocalVoxelEncoder as J
    from ddmi_tpu_torch.core.convocc_config import voxel_encoder_kwargs
    from ddmi_tpu_torch.nn.pointnet import LocalVoxelEncoder

    enc = {"plane_resolution": reso, "unet3d": grid,
           "plane_type": ["xz", "xy", "yz"] + (["grid"] if grid else [])}
    if unet:
        enc.update(unet=True, unet_kwargs={"depth": 2, "start_filts": 4})
    conv = {"model": {"c_dim": 4, "encoder_kwargs": enc}}
    assert voxel_encoder_kwargs(conv) == jkw(conv)
    vox = _batch(5, voxels=8)["inputs"]
    jm = J(**jkw(conv))  # its UNet3D at the JAX module's fixed f_maps 32, 3 levels
    params = _random(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(vox))["params"],
                     6)
    ref = jm.apply({"params": params}, jnp.asarray(vox))
    tm = LocalVoxelEncoder(**voxel_encoder_kwargs(conv))
    tm.load_state_dict(interop.voxel_encoder_from_jax(params, 2))
    with torch.no_grad():
        got = tm(torch.from_numpy(vox))
    assert set(got) == set(ref)
    for k in ("xz", "xy", "yz"):
        _close(got[k].permute(0, 2, 3, 1), ref[k], k)
    if grid:
        _close(got["grid"].permute(0, 2, 3, 4, 1), ref["grid"], "grid")


def test_onet_pipeline_steps_match_optax():
    """3 Adam steps on one batch: each loss, then every parameter."""
    jpipe, params, pipe, batch = _pipelines("pointnet_local_pool", POINT_EK, DK)
    from ddmi_tpu.domains.onet import ONetState

    jstate = ONetState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=jpipe.tx.init(params))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = pipe.init()
    step = jax.jit(jpipe.train_step)
    for i in range(3):
        jstate, jm = step(jstate, jb)
        state, m = pipe.train_step(state, batch)
        _close(np.float32(m["loss"]), jm["loss"], f"loss {i}", rel=1e-4)
    assert state.step == 3 and state.opt.count == 3
    enc = interop.pointnet_unet_from_jax(jax.device_get(jstate.params["encoder"]), 2, 2)
    ref = interop.conv_onet_from_jax(jax.device_get(jstate.params), enc, 2)
    got = pipe.model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], k, rel=1e-4)


def test_onet_eval_iou_and_mesh_eval_fn_match_jax():
    from ddmi_tpu.geometry.generation import MeshGenerator as JaxMesh
    from ddmi_tpu_torch.geometry.generation import MeshGenerator

    jpipe, params, pipe, batch = _pipelines("pointnet_local_pool", POINT_EK, DK, seed=3)
    # the encoder's random weights give logits around the threshold's
    assert pipe.eval_iou(batch) == jpipe.eval_iou(params, {k: jnp.asarray(v)
                                                           for k, v in batch.items()})
    cloud = batch["inputs"][:1]
    jfn = jax.jit(jpipe.mesh_eval_fn(params, jnp.asarray(cloud)))
    fn = pipe.mesh_eval_fn(cloud)
    q = np.random.default_rng(4).uniform(-0.55, 0.55, (1, 200, 3)).astype(np.float32)
    with torch.no_grad():
        got = fn(torch.from_numpy(q))
    _close(got, jfn(jnp.asarray(q)), "mesh_eval_fn")
    thr = float(np.median(np.asarray(jfn(jnp.asarray(q)))))
    prob = float(1 / (1 + np.exp(-thr)))
    jv, jt = JaxMesh(jfn, threshold=prob, resolution0=12, upsampling_steps=0).generate()
    v, t = MeshGenerator(fn, threshold=prob, resolution0=12, upsampling_steps=0).generate()
    assert len(t) > 0 and np.array_equal(t, jt)
    _close(v, jv, "mesh vertices", rel=1e-4)


def test_onet_voxel_pipeline_matches_jax():
    """The voxel variant through ConvONet: logits and one step's loss."""
    ek = dict(plane_resolution=8, unet=True, unet_depth=2, unet_start_filts=4)
    jpipe, params, pipe, batch = _pipelines("voxel_simple_local", ek, DK, seed=5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        got = pipe.model(torch.from_numpy(batch["points"]), torch.from_numpy(batch["inputs"]))
    _close(got, jpipe.model.apply({"params": params}, jb["points"], jb["inputs"]), "logits")
    _close(np.float32(pipe.train_step(pipe.init(), batch)[1]["loss"]),
           jpipe.loss(params, jb), "loss", rel=1e-4)


def test_onet_registry_and_convocc_reader():
    from ddmi_tpu_torch.core.convocc_config import load_convocc_config
    from ddmi_tpu_torch.domains.onet import ENCODER_REGISTRY, ONetPipeline
    from ddmi_tpu_torch.nn.pointnet import LocalPoolPointnet, LocalVoxelEncoder
    from ddmi_tpu_torch.nn.pointnetpp import PointNetPlusPlus

    assert ENCODER_REGISTRY == {"pointnet_local_pool": LocalPoolPointnet,
                                "voxel_simple_local": LocalVoxelEncoder,
                                "pointnet_plus_plus": PointNetPlusPlus}
    with pytest.raises(ValueError):  # the JAX pipeline builds LocalPoolPointnet here
        ONetPipeline(encoder="pointnet_local_poool", device="cpu")
    conv = load_convocc_config("configs/convocc/pointcloud/shapenet_3plane.yaml")
    conv = copy.deepcopy(conv)
    conv["model"]["encoder_kwargs"].update(hidden_dim=16, plane_resolution=8, n_blocks=2)
    pipe = ONetPipeline.from_convocc(conv, device="cpu")
    enc = pipe.model.encoder
    assert isinstance(enc, LocalPoolPointnet) and enc.c_dim == 32 and enc.reso == 8
    assert pipe.threshold == 0.2 and len(pipe.model.decoder.blocks) == 5
    conv["model"].update(encoder="voxel_simple_local")
    assert isinstance(ONetPipeline.from_convocc(conv, device="cpu").model.encoder,
                      LocalVoxelEncoder)


def test_occupancy_pipeline_takes_the_voxel_encoder(tmp_path):
    """data.conv_config naming voxel_simple_local builds LocalVoxelEncoder
    from voxel_encoder_kwargs; stage 1 refuses it, where JAX's
    init_stage1 fails on its (1, 64, 3) cloud."""
    import yaml

    from ddmi_tpu.domains.occupancy import OccupancyPipeline as JaxOcc
    from ddmi_tpu.core.config import config_from_dict as jax_config
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline
    from ddmi_tpu_torch.nn.pointnet import LocalVoxelEncoder

    path = tmp_path / "voxel.yaml"
    path.write_text(yaml.safe_dump({"model": {"encoder": "voxel_simple_local", "c_dim": 8,
                                              "encoder_kwargs": {"plane_resolution": 16}}}))
    dd = dict(double_z=True, z_channels=8, resolution=16, in_channels=8, out_ch=8, ch=32,
              ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], hdbf_resolutions=[8],
              inter_attn_resolutions=[16], attn_type="vanilla")
    cfg = {"model": {"embed_dim": 4, "params": {
        "ddconfig": dd,
        "unetconfig": dict(image_size=8, in_channels=12, model_channels=32, out_channels=12,
                           num_res_blocks=1, attention_resolutions=[], channel_mult=[1]),
        "ddpmconfig": dict(timesteps=20, image_size=8, channels=12, sampling_timesteps=2),
        "mlpconfig": dict(in_ch=3, out_ch=1, ch=16, latent_dim=8)}},
        "data": {"domain": "occupancy", "conv_config": str(path)}}
    pipe = OccupancyPipeline(config_from_dict(cfg), device="cpu")
    assert isinstance(pipe.pointnet, LocalVoxelEncoder) and pipe.pointnet.reso == 16
    with torch.no_grad():
        planes = pipe.pointnet(torch.from_numpy(_batch(7, voxels=16)["inputs"]))
    assert planes["xy"].shape == (2, 8, 16, 16)
    with pytest.raises(ValueError):
        pipe.init_stage1(10)
    jpipe = JaxOcc(jax_config(cfg))
    with pytest.raises(ValueError):
        jax.eval_shape(lambda: jpipe.init_stage1(jax.random.PRNGKey(0), 10))


def _bridge_cases():
    from ddmi_tpu.nn import conv_unet as jcu
    from ddmi_tpu.nn import onet as jon
    from ddmi_tpu.nn import pointnet as jpn
    from ddmi_tpu.nn import pointnetpp as jpp
    from ddmi_tpu.nn import stylegan as jsg
    from ddmi_tpu.ops import fused as jfu
    from ddmi_tpu_torch.nn import conv_unet, onet, pointnet, pointnetpp, stylegan
    from ddmi_tpu_torch.ops import fused

    planes = {k: jnp.zeros((1, 8, 8, 4)) for k in ("xz", "xy", "yz")}
    img, cloud = jnp.zeros((1, 8, 8, 6)), jnp.zeros((1, 600, 3))
    return {
        "local_decoder": (jon.LocalDecoder(c_dim=4, hidden_size=8, n_blocks=2),
                          (jnp.zeros((1, 5, 3)), planes),
                          lambda: onet.LocalDecoder(c_dim=4, hidden_size=8, n_blocks=2),
                          lambda t: interop.local_decoder_from_jax(t, 2)),
        "unet2d": (jcu.UNet2D(4, depth=3, start_filts=4), (img,),
                   lambda: conv_unet.UNet2D(4, 6, depth=3, start_filts=4),
                   lambda t: interop.unet2d_from_jax(t, 3)),
        "unet3d": (jcu.UNet3D(4, f_maps=4), (jnp.zeros((1, 4, 4, 4, 2)),),
                   lambda: conv_unet.UNet3D(4, 2, f_maps=4),
                   lambda t: interop.unet3d_from_jax(t, 3)),
        "pointnet_unet": (jpn.LocalPoolPointnet(c_dim=4, hidden_dim=8, plane_resolution=8,
                                                n_blocks=2, unet=True, unet_depth=2,
                                                unet_start_filts=4), (cloud,),
                          lambda: pointnet.LocalPoolPointnet(c_dim=4, hidden_dim=8,
                                                             plane_resolution=8, n_blocks=2,
                                                             unet=True, unet_depth=2,
                                                             unet_start_filts=4),
                          lambda t: interop.pointnet_unet_from_jax(t, 2, 2)),
        "voxel_encoder": (jpn.LocalVoxelEncoder(c_dim=4, plane_resolution=8,
                                                plane_type=("xz", "grid"), unet=True,
                                                unet_depth=2, unet_start_filts=4, unet3d=True),
                          (jnp.zeros((1, 8, 8, 8)),),
                          lambda: pointnet.LocalVoxelEncoder(c_dim=4, plane_resolution=8,
                                                             plane_type=("xz", "grid"), unet=True,
                                                             unet_depth=2, unet_start_filts=4,
                                                             unet3d=True),
                          lambda t: interop.voxel_encoder_from_jax(t, 2)),
        "pointnetpp": (jpp.PointNetPlusPlus(c_dim=8), (cloud,),
                       lambda: pointnetpp.PointNetPlusPlus(c_dim=8), interop.pointnetpp_from_jax),
        "equal_conv2d": (jsg.EqualConv2d(4, 3), (img,), lambda: stylegan.EqualConv2d(6, 4, 3),
                         interop.equal_conv2d_from_jax),
        "modulated_conv": (jsg.ModulatedConv(4, 3, upsample=True), (img, jnp.zeros((1, 5))),
                           lambda: stylegan.ModulatedConv(6, 4, 5, kernel_size=3, upsample=True),
                           interop.modulated_conv_from_jax),
        "fast_group_norm": (jfu.FastGroupNorm(num_groups=2), (img,),
                            lambda: fused.FastGroupNorm(6, num_groups=2),
                            interop.fast_group_norm_from_jax),
    }


@pytest.mark.parametrize("name", ["local_decoder", "unet2d", "unet3d", "pointnet_unet",
                                  "voxel_encoder", "pointnetpp", "equal_conv2d",
                                  "modulated_conv", "fast_group_norm"])
def test_bridge_round_trip(name):
    """Each new `*_from_jax`: the port module loads the converted tree
    strictly (every key, every shape), and the state it holds then carries
    every value of the JAX tree once and nothing else (the sorted values
    equal): a transpose or a rename of each leaf, bit for bit."""
    jm, args, make, convert = _bridge_cases()[name]
    tree = _random(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"], 9)
    m = make()
    m.load_state_dict(convert(tree), strict=True)
    held = np.sort(np.concatenate([v.numpy().ravel() for v in m.state_dict().values()]))
    leaves = np.sort(np.concatenate([np.asarray(v).ravel()
                                     for v in jax.tree_util.tree_leaves(tree)]))
    assert np.array_equal(held, leaves)
