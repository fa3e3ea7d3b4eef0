"""Distribution of the PyTorch port (ddmi_tpu_torch/parallel) on the CPU.

Against the JAX package: `make_mesh`'s resolved sizes and its fallback
warning on the 8 host devices tests/conftest.py gives JAX, and the
placement rule (`_fsdp_spec_for`, `shard_state`, `shard_params_tp_fsdp`)
on every leaf of the celebahq stage-2 parameters, from jax.eval_shape and
the port's meta-device UNet (nothing is compiled or allocated).

Against the port's own one-process run (which the step tests hold against
JAX): one 2-process gloo group, started once, runs at small widths
- stage 1 of the adversarial image config (1 micro-step) and a stage-2
  window (2 micro-steps) at mesh {data: 2}, then `generate` (4 samples
  data-parallel) on their checkpoints;
- stage-2 windows at {fsdp: 2} under model.amp (FSDP2 with its mixed
  precision), at 8 latent channels and at 9 (a leaf kept whole, cast by
  the forward hooks of `shard_module`), and the restore of a one-process
  checkpoint into their sharded states.
Only the order of the reductions differs from the one-process run, so the
bars are the step tests' against JAX (tests/test_torch_video_steps.py):
the Adam moments within 1e-3 relative (L2) plus 1e-5 of their kind's
global norm, each parameter's first update as `_check_first_update` holds
it (the elements whose gradient is roundoff left out of its sign count),
the EMA within 1e-6 relative; the stage-1 discriminator after its
update within 1e-4 relative but for at most 0.1% of elements (their
gradient near zero: Adam's first step takes roundoff's sign there) that
may differ by 2 lr, and the biases before a batch norm (a roundoff
gradient) within lr; the losses within 1e-5 relative; the generated
pixels within 1e-5.  A checkpoint written at world size 2 restores at
world size 1 bit for bit, and a one-process one into the sharded state
bit for bit.
"""

import dataclasses
import json
import os
import socket
import warnings

import numpy as np
import pytest
import torch

from ddmi_tpu_torch.core.config import config_from_dict
from ddmi_tpu_torch.parallel import mesh as pm

torch.set_num_threads(2)

B, LR = 4, 1e-3
# the {fsdp: 2} runs, both under amp: at 8 latent channels (FSDP2's mixed
# precision), and at 9, where the UNet's output bias has no axis 2 divides
# and stays whole, out of FSDP2 (its bf16 cast made by shard_module's
# hooks; the UNet reads that bias without calling its conv module)
FSDP_RUNS = {"fsdp2": (True, 8), "fsdp2_whole": (True, 9)}


def _cfg(save, mesh, amp=False, channels=8):
    """tests/test_cli_smoke.py's tiny image config, adversarial, with a
    2-micro-step accumulation window in stage 2 and a constant stage-1
    rate for the discriminator; `channels` latent channels."""
    return config_from_dict({
        "seed": 5, "mesh": mesh,
        "model": {
            "use_fp16": amp, "amp": amp, "lr": LR, "embed_dim": channels,
            "params": {
                "lossconfig": {"epochs": 1, "warmup_epochs": 0, "save_and_sample_every": 1,
                               "gradient_accumulate_every": 2, "sn_reg": True,
                               "multiscale": False, "adversarial": True, "disc_weight": 0.5},
                "ddconfig": {"double_z": True, "z_channels": 32, "resolution": 32,
                             "in_channels": 3, "out_ch": 16, "ch": 32, "ch_mult": [1, 2, 4],
                             "num_res_blocks": 1, "attn_resolutions": [],
                             "hdbf_resolutions": [8, 16]},
                "mlpconfig": {"in_ch": 2, "out_ch": 3, "ch": 64, "latent_dim": 16},
                "unetconfig": {"image_size": 8, "in_channels": channels, "model_channels": 32,
                               "out_channels": channels, "num_res_blocks": 1,
                               "attention_resolutions": [2], "channel_mult": [1, 2],
                               "num_head_channels": 16},
                "ddpmconfig": {"timesteps": 20, "image_size": 8, "channels": channels,
                               "sampling_timesteps": 4},
            },
        },
        "data": {"domain": "image", "dataset": "synthetic", "save_pth": save,
                 "batch_size": B, "test_batch_size": B, "test_resolution": 16,
                 "extra": {"prefetch": 0}},
    })


def _pipe(cfg):
    """The pipeline of cfg with every all-zero parameter given seeded
    N(0, 0.05^2) values (the same on every rank), so that every gradient
    path is live."""
    from ddmi_tpu_torch.domains.image import ImagePipeline

    pipe = ImagePipeline(cfg, device="cpu", seed=cfg.seed)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for _, p in sorted(pipe.named_parameters()):
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return pipe


def _images(seed, n=B):
    return np.random.default_rng(seed).random((n, 32, 32, 3)).astype(np.float32)


def _numpy(obj):
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_numpy(v) for v in obj]
    if torch.is_tensor(obj):
        return obj.detach().cpu().float().numpy() if obj.dtype == torch.bfloat16 else \
            obj.detach().cpu().numpy()
    return obj


def _state(state):
    """A train state's tensors, gathered whole, as numpy."""
    return _numpy(pm.gather_full(state.state_dict()))


def _placements(state):
    """{name: (DTensor or not, the rank's shape)} of a stage-2 state's
    parameters, and whether each Adam mu is split."""
    return ({k: (pm.is_sharded(p), tuple(p.to_local().shape) if pm.is_sharded(p)
                 else tuple(p.shape)) for k, p in state.params.items()},
            [pm.is_sharded(m) for m in state.opt.inner.mu])


def _run_data2(save):
    """Stage 1 (1 adversarial micro-step), the stage-2 window and generate
    at mesh {data: 2}: -> their states, losses and samples."""
    from ddmi_tpu_torch.core.trainer import Trainer

    cfg = _cfg(save, {"data": 2})
    pipe = _pipe(cfg)
    s1 = Trainer(cfg, pipe, [_images(1)]).train_stage1(epochs=1, eval_hook=lambda *a: None)
    out = {"s1": _state(s1)}
    s2 = Trainer(cfg, pipe, [_images(2), _images(3)]).train_stage2(
        epochs=1, eval_hook=lambda *a: None)
    out.update(s2=_state(s2), log=_log(save), placements=_placements(s2))
    out["gen"] = Trainer(cfg, _pipe(cfg), []).generate(n=B)
    return out


def _log(save):
    """The records the trainers wrote (rank 0's: the ranks' mean)."""
    path = os.path.join(save, "train.jsonl")
    return [json.loads(line) for line in open(path)] if os.path.exists(path) else []


def _run_fsdp2(save, ref_dir, case="fsdp2"):
    """The stage-2 window at mesh {fsdp: 2} (FSDP_RUNS[case]), and the
    restore of the one-process checkpoint in ref_dir into a state split
    alike."""
    from ddmi_tpu_torch.core.checkpoint import CheckpointManager
    from ddmi_tpu_torch.core.trainer import Trainer, _Resumable
    from ddmi_tpu_torch.parallel.mesh import MeshSpec, make_mesh, shard_module

    amp, channels = FSDP_RUNS[case]
    cfg = _cfg(save, {"fsdp": 2}, amp=amp, channels=channels)
    pipe = _pipe(cfg)
    # with its checkpoint and the default eval hook: sampling with the EMA
    # weights of the split UNet (core/trainer.py::_sharded_ema_weights)
    s2 = Trainer(cfg, pipe, [_images(2), _images(3)]).train_stage2(epochs=1)
    out = {"s2": _state(s2), "log": _log(save),
           "samples": sorted(os.listdir(os.path.join(save, "samples"))),
           "placements": _placements(s2)}
    pipe = _pipe(cfg)
    mesh = make_mesh(MeshSpec(1, 2, 1))
    state = pipe.init_stage2(wrap=lambda p: shard_module(p.unet, mesh, amp=amp))
    CheckpointManager(ref_dir, prefix="stage2").restore(
        _Resumable(state, torch.Generator().manual_seed(0)))
    out["restored"] = _state(state)
    return out


def _worker(rank, world, port, root):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    warnings.simplefilter("ignore")
    from ddmi_tpu_torch.parallel import distributed

    assert distributed.maybe_initialize("cpu") and distributed.world_size() == world
    try:
        out = {"data2": _run_data2(os.path.join(root, "w2_data"))}
        for case in FSDP_RUNS:
            out[case] = _run_fsdp2(os.path.join(root, f"w2_{case}"),
                                   os.path.join(root, f"w1_{case}"), case)
        if rank == 0:
            torch.save(out, os.path.join(root, "world2.pt"))
    finally:
        distributed.destroy()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process runs, the 2-process runs' results from rank 0)."""
    from ddmi_tpu_torch.core.trainer import Trainer

    root = str(tmp_path_factory.mktemp("parallel"))
    # the ranks' thread count here too: CPU kernels may sum in another
    # order with another count (a test module imported later may set it)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = {"data2": _run_data2(os.path.join(root, "w1_data"))}
        for case, (amp, channels) in FSDP_RUNS.items():
            cfg = _cfg(os.path.join(root, f"w1_{case}"), {"fsdp": 2}, amp=amp, channels=channels)
            s2 = Trainer(cfg, _pipe(cfg), [_images(2), _images(3)]).train_stage2(
                epochs=1, eval_hook=lambda *a: None)
            one[case] = {"s2": _state(s2), "log": _log(cfg.data.save_pth)}
    torch.set_num_threads(threads)
    torch.multiprocessing.start_processes(_worker, args=(2, _free_port(), root), nprocs=2,
                                          join=True, start_method="spawn")
    two = torch.load(os.path.join(root, "world2.pt"), weights_only=False)
    return one, two, root


def _check_moments(ours, ref):
    """Every Adam moment within 1e-3 relative (L2) plus 1e-5 of its kind's
    global norm."""
    total = np.sqrt(sum(float(np.sum(np.square(r))) for r in ref))
    for t, r in zip(ours, ref):
        assert np.linalg.norm(t - r) <= 1e-3 * np.linalg.norm(r) + 1e-5 * total


def _check_first_update(now, start, ref_now, ref_mu, lr):
    """Adam's first update moves each element by about lr * sign(g): every
    element at most lr, and at least 99% of the elements whose gradient is
    steady in the reference's direction.  Steady: the reference's first
    moment (mu = (1 - b1) g after one update) above 1e-3 of its tensor's
    RMS; below it the gradient is roundoff of the reduction order, and so
    is its sign (tests/test_torch_stage1_steps.py masks such elements
    alike)."""
    agree = total = 0
    for (k, r), mu in zip(ref_now.items(), ref_mu):
        d, rd = now[k] - start[k], r - start[k]
        assert np.abs(d).max() <= 1.01 * lr, k
        steady = np.abs(mu) > 1e-3 * np.sqrt(np.mean(np.square(mu)))
        agree += int(np.sum(np.sign(d[steady]) == np.sign(rd[steady])))
        total += int(steady.sum())
    assert total and agree >= 0.99 * total, (agree, total)


def _check_losses(got, ref, prefix):
    got = [r for r in got if prefix + "loss" in r]
    ref = [r for r in ref if prefix + "loss" in r]
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a["step"] == b["step"]
        for k in ("loss", "d_loss", "g_gan"):
            if prefix + k in b:
                k = prefix + k
                assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("case", ["data2", "fsdp2", "fsdp2_whole"])
def test_stage2_window_matches_one_process(runs, case):
    """The stage-2 window (2 micro-steps, one update) at {data: 2} (plain
    replication), at {fsdp: 2} under amp (FSDP2 and its mixed precision)
    and at {fsdp: 2} under amp with 9 latent channels: the losses, the Adam
    moments, the update and the EMA as the one-process run's, within the
    bars above; the UNet's parameters and Adam moments are FSDP2 DTensors
    (at {fsdp: 2} split along the rule's dim) and the mixing logit plain,
    at 9 channels the UNet's output bias stays whole (no axis 2 divides),
    its gradient averaged outside FSDP2 and its bf16 cast made for the
    whole forward; and at 8 channels the eval hook samples with the split
    UNet's EMA weights without a logged failure."""
    one, two, _ = runs
    ref, got = one[case]["s2"], two[case]["s2"]
    _check_losses(two[case]["log"], one[case]["log"], "s2/")
    names = list(ref["params"])
    assert list(got["params"]) == names
    for kind in ("mu", "nu"):
        _check_moments(got["opt"]["inner"][kind], ref["opt"]["inner"][kind])
    assert all(not a.any() for a in got["opt"]["acc"])
    amp, channels = FSDP_RUNS.get(case, (False, 8))
    ref0 = _pipe(_cfg("/nonexistent", {}, amp=amp, channels=channels)).stage2_params()
    start = {k: ref0[k].detach().numpy() for k in names}
    _check_first_update(got["params"], start, ref["params"], ref["opt"]["inner"]["mu"], LR)
    for k in names:
        e, r = got["ema"][k], ref["ema"][k]
        assert np.linalg.norm(e - r) <= 1e-6 * np.linalg.norm(r), k
    assert got["step"] == ref["step"] == 2
    # the UNet's parameters and Adam moments are FSDP2's DTensors: at
    # {data: 2} whole on each rank (replicated), at {fsdp: 2} split along
    # the rule's dim; the mixing logit plain
    placed, mu_split = two[case]["placements"]
    whole = ["mixing_logit"] + (["unet.out.2.bias"] if case == "fsdp2_whole" else [])
    assert sorted(k for k, (split, _) in placed.items() if not split) == sorted(whole)
    shards = [k for k, (split, _) in placed.items() if split]
    assert sum(mu_split) == len(shards)
    for k in shards:
        want = list(ref["params"][k].shape)
        if case != "data2":
            want[pm.port_fsdp_dim(want, 2)] //= 2
        assert list(placed[k][1]) == want, k
    if case == "fsdp2":
        assert not [r for r in two[case]["log"] if "s2/eval_hook_failures" in r]
        assert two[case]["samples"] == ["ep0_0.png", "ep0_1.png"]


def test_stage1_adversarial_micro_step_matches_one_process(runs):
    """One adversarial stage-1 micro-step at {data: 2}: the PatchGAN's
    batch norm takes the global batch's statistics, so the losses, the
    accumulated gradients of the VAE and the INR (held as the Adam moments
    are), the discriminator after its update and the SN vectors (1e-5
    relative) are the one-process run's, within the bars above."""
    one, two, _ = runs
    ref, got = one["data2"]["s1"], two["data2"]["s1"]
    _check_losses(two["data2"]["log"], one["data2"]["log"], "s1/")
    # the window's running mean of the gradients (the update comes at 2)
    _check_moments(got["opt"]["acc"], ref["opt"]["acc"])
    for k, r in ref["disc"].items():
        g = got["disc"][k]
        if k in ("discriminator.convs.1.bias", "discriminator.convs.2.bias",
                 "discriminator.convs.3.bias"):
            assert np.abs(g - r).max() <= 2.02 * LR, k
            continue
        flip = np.abs(g - r) > 1e-6 * np.abs(r).max()
        assert flip.mean() <= 1e-3 and np.abs(g - r).max() <= 2.02 * LR, k
        ok = ~flip
        assert np.linalg.norm(g[ok] - r[ok]) <= 1e-4 * np.linalg.norm(r[ok]), k
    for k in ref["sn"]:
        for a, b in zip(got["sn"][k], ref["sn"][k]):
            assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), k


def test_generate_is_data_parallel_and_matches_one_process(runs):
    """generate(4) at {data: 2}: each rank samples 2 rows of the global
    noise and the latents are gathered; the images equal the one-process
    run's within 1e-5."""
    one, two, _ = runs
    ref, got = one["data2"]["gen"], two["data2"]["gen"]
    assert got.shape == ref.shape == (B, 16, 16, 3)
    assert np.abs(got - ref).max() <= 1e-5


def test_checkpoints_restore_across_world_sizes(runs):
    """The stage-2 checkpoint written at world size 2 (rank 0, gathered)
    restores into a one-process state bit for bit; the one-process
    checkpoints restore into the {fsdp: 2} split states bit for bit."""
    from ddmi_tpu_torch.core.trainer import Trainer

    one, two, root = runs
    cfg = _cfg(os.path.join(root, "w2_data"), {"data": 2})
    restored = _numpy(Trainer(cfg, _pipe(cfg), []).load_stage2().state_dict())
    _equal(restored, two["data2"]["s2"])
    for case in FSDP_RUNS:
        _equal(two[case]["restored"], one[case]["s2"])


def _equal(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(b, np.ndarray):
        assert a.shape == b.shape and np.array_equal(a, b)
    else:
        assert a == b


# ------------------------------------------------- against the JAX package

MESH_CASES = [((-1, 1, 1), 8), ((-1, 1, 1), 1), ((4, 2, 1), 8), ((4, 2, 1), 1),
              ((-1, 2, 1), 8), ((-1, 4, 1), 8), ((2, 2, 2), 8), ((-1, 1, 2), 4),
              ((3, 1, 1), 8), ((-1, 3, 1), 8), ((1, 2, 1), 2)]


@pytest.mark.parametrize("spec,n", MESH_CASES)
def test_make_mesh_resolves_as_jax(spec, n):
    """make_mesh's sizes and its fallback warning against JAX's make_mesh on
    the first n of the 8 host devices."""
    import jax

    from ddmi_tpu.parallel import mesh as jm

    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ref = jm.make_mesh(jm.MeshSpec(*spec), devices=jax.devices()[:n])
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        got = pm.make_mesh(pm.MeshSpec(*spec), world_size=n)
    assert (got.data, got.fsdp, got.model) == (ref.shape["data"], ref.shape["fsdp"],
                                               ref.shape["model"])
    fell = [str(w.message) for w in wj if "falling back" in str(w.message)]
    assert [str(w.message) for w in wp if "falling back" in str(w.message)] == fell


def _role(axis, ndim):
    """The logical role of a JAX weight axis: (*kernel, in, out)."""
    if ndim < 2:
        return "vector"
    return {ndim - 1: "out", ndim - 2: "in"}.get(axis, "kernel")


def _port_role(dim, ndim):
    """The logical role of a port weight dim: (out, in, *kernel)."""
    if ndim < 2:
        return "vector"
    return {0: "out", 1: "in"}.get(dim, "kernel")


@pytest.fixture(scope="module")
def celebahq_leaves():
    """[(JAX path, JAX shape, port name, port shape)] over the celebahq
    stage-2 parameters: the UNet's leaves paired through the port's
    converter run on a narrow UNet of the same structure (each JAX leaf
    filled with its index), and the mixing logit."""
    import jax

    from ddmi_tpu.core.config import load_config as jax_load
    from ddmi_tpu.domains.image import ImagePipeline as JaxPipe
    from ddmi_tpu_torch.core.config import load_config
    from ddmi_tpu_torch.interop import unet_from_jax
    from ddmi_tpu_torch.nn.unet import UNet

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs/ldm/celebahq.yaml")
    jcfg = jax_load(path, exp="ldm")
    full = jax.eval_shape(lambda: JaxPipe(jcfg).init_stage2_params(jax.random.PRNGKey(0)))
    cfg = load_config(path, exp="ldm")
    with torch.device("meta"):
        port = dict(UNet(cfg.model.unetconfig).named_parameters())
    ucfg = dataclasses.replace(cfg.model.unetconfig, model_channels=32)
    jm = dataclasses.replace(jcfg.model.unetconfig, model_channels=32)
    from ddmi_tpu.nn.unet import UNet as JaxUNet

    narrow = jax.eval_shape(lambda: JaxUNet(jm).init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, 64, 64, 64)),
        jax.numpy.zeros((1,), jax.numpy.int32)))["params"]
    flat, tree = jax.tree_util.tree_flatten_with_path(narrow)
    tagged = jax.tree_util.tree_unflatten(tree, [np.full(s.shape, i, np.float32)
                                                 for i, (_, s) in enumerate(flat)])
    sd = unet_from_jax(tagged, ucfg)
    full_flat = dict(jax.tree_util.tree_flatten_with_path(full["unet"])[0])
    keys = [p for p, _ in flat]
    out = []
    for name, t in sd.items():
        tag = t.reshape(-1)[0].item()
        assert torch.all(t == tag), name
        jpath = keys[int(tag)]
        out.append((jax.tree_util.keystr(jpath), tuple(full_flat[jpath].shape), name,
                    tuple(port[name].shape)))
    assert len(out) == len(flat) == len(port)
    out.append(("['mixing_logit']", tuple(full["mixing_logit"].shape), "mixing_logit",
                (1, cfg.model.ddpmconfig.channels, 1, 1)))
    return out


@pytest.mark.parametrize("fsdp,model", [(2, 1), (4, 1), (2, 2)])
def test_placement_rule_matches_jax_on_celebahq(celebahq_leaves, fsdp, model):
    """For every leaf of the celebahq stage-2 parameters, JAX's
    shard_state (through `_fsdp_spec_for`, or `shard_params_tp_fsdp` at
    model 2) on a mesh of the 8 host devices against the port's rule on
    the port's layout: sharded or whole, the elements each rank holds, and
    the logical axis split (kernel / in / out).  The one noted exception is
    the mixing logit, JAX (1, 1, 1, C) and the port (1, C, 1, 1), where
    jax_axes reads C as an input channel: both split C alone, over 'fsdp'
    (over 'model' at model 2 in JAX, which the trainer refuses)."""
    import jax

    from ddmi_tpu.parallel import mesh as jm

    mesh = jm.make_mesh(jm.MeshSpec(8 // (fsdp * model), fsdp, model))
    n = fsdp * model
    for jpath, jshape, name, pshape in celebahq_leaves:
        spec = jm.shard_state(mesh, jax.ShapeDtypeStruct(jshape, np.float32)).spec
        spec = tuple(spec) + (None,) * (len(jshape) - len(spec))
        axes = pm.jax_axes(len(pshape))
        got = pm.shard_state([pshape[d] for d in axes], pm.MeshSpec(8 // n, fsdp, model))
        split = lambda sp, shape: int(np.prod(shape)) // int(np.prod(
            [{"fsdp": fsdp, "model": model}.get(a, 1) for a in sp]))
        assert split(got, pshape) == split(spec, jshape), (name, jpath, got, spec)
        if name == "mixing_logit":  # the noted exception: C alone is split
            assert sum(a is not None for a in got) == sum(a is not None for a in spec) == 1
            continue
        for axis_name in ("fsdp", "model"):
            want = [i for i, a in enumerate(spec) if a == axis_name]
            have = [axes[i] for i, a in enumerate(got) if a == axis_name]
            assert len(want) == len(have), (name, axis_name, spec, got)
            if not want:
                continue
            assert jshape[want[0]] == pshape[have[0]], (name, spec, got)
            assert _role(want[0], len(jshape)) == _port_role(have[0], len(pshape)), (
                name, jpath, spec, got)
        if model == 1:
            d = pm.port_fsdp_dim(pshape, fsdp)
            assert (d is None) == ("fsdp" not in spec), name


@pytest.mark.parametrize("b", [4, 5])
def test_image_folder_shards_keep_the_global_batch(tmp_path, b):
    """At {data: 2} the CLI's image-folder loaders (one per data rank, each
    reading every 2nd file) give each rank ceil(b / 2) rows, so that the
    trainer's global batch is b padded to a multiple of 2, as JAX's
    one-host run pads it, and an epoch has the one-process run's steps; the
    two shards' files are disjoint and cover the folder.  A loader that is
    not sharded gives each rank its rows of the same global batch."""
    import types

    from PIL import Image

    from ddmi_tpu_torch.cli.main import build_dataset
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.data import SyntheticImages

    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    for i in range(12):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
            tmp_path / "imgs" / f"{i}.png")
    cfg = _cfg(str(tmp_path / "save"), {"data": 2})
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset="imgs", data_dir=str(tmp_path / "imgs"), batch_size=b))
    one = build_dataset(cfg, train=True)
    shards = [build_dataset(cfg, train=True, num_processes=2, process_index=i) for i in (0, 1)]
    assert one.batch_size == b and [d.batch_size for d in shards] == [-(-b // 2)] * 2
    assert [len(d) for d in shards] == [len(one)] * 2
    assert not set(shards[0].files) & set(shards[1].files)
    assert sorted(shards[0].files + shards[1].files) == sorted(one.files)
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    plain = SyntheticImages(b, resolution=32)
    for index, d in enumerate(shards):
        mesh = types.SimpleNamespace(get_local_rank=lambda axis, i=index: i,
                                     size=lambda dim: 2)
        local, glob = Trainer(cfg, cpu, d, mesh=mesh)._local_batch(next(iter(d)))
        assert local.shape[0] == -(-b // 2) and glob == pm.padded_size(b, 2)
        x = next(iter(plain))
        local, glob = Trainer(cfg, cpu, plain, mesh=mesh)._local_batch(x)
        assert glob == pm.padded_size(b, 2)
        assert np.array_equal(local, pm.shard_batch(x, index, 2, warn=False))


@pytest.mark.parametrize("b", [4, 5, 7])
def test_shard_batch_pads_and_splits_as_jax(b):
    """shard_batch's rows on 2 data ranks, put back together, are the global
    batch JAX's trainer puts on a data axis of 2 (`_put_batch`: padded by
    wrap-around to a multiple of 2), for dict batches too."""
    import jax

    from ddmi_tpu.core.trainer import Trainer as JaxTrainer
    from ddmi_tpu.parallel import mesh as jm

    x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.mesh = jm.make_mesh(jm.MeshSpec(2, 1, 1), devices=jax.devices()[:2])
    jt.data_sh = jm.batch_sharding(jt.mesh)
    jt._warned_trim = False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.asarray(jt._put_batch(x))
        got = [pm.shard_batch({"x": x, "t": torch.from_numpy(x)}, i, 2) for i in range(2)]
    assert np.array_equal(np.concatenate([g["x"] for g in got]), ref)
    assert np.array_equal(torch.cat([g["t"] for g in got]).numpy(), ref)


def test_maybe_initialize_reads_torchrun_and_never_falls_back(monkeypatch):
    """Without torchrun's variables maybe_initialize does nothing; with them,
    a CUDA rank without its card raises instead of running on the CPU."""
    from ddmi_tpu_torch.parallel import distributed

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize("cuda") is False
    assert not distributed.initialized() and distributed.world_size() == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0"):
        distributed.maybe_initialize("cuda")
    assert not distributed.initialized()


def test_trainer_refuses_the_model_axis(tmp_path):
    """mesh.model > 1 raises ValueError with its reason."""
    from ddmi_tpu_torch.core.trainer import Trainer

    cfg = _cfg(str(tmp_path), {"data": 1, "fsdp": 1, "model": 2})
    with pytest.raises(ValueError, match="kernels take whole tensors"):
        Trainer(cfg, _pipe(cfg), [])
