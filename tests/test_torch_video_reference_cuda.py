"""The port's video sampling path through the card's kernels against the
benchmark's plain reference, at a small size: SamplerService on the card
(bf16, the fused attention block, `mha_vmem` and the flash forward) against
benchmark/domains/video.py::reference in float32 with TF32 off.

Marked `cuda`: it skips without a CUDA device.  The file imports no JAX:

    python -m pytest --noconftest tests/test_torch_video_reference_cuda.py -m cuda -q
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check  # noqa: E402
from benchmark.reference.numerics import Numerics, fp32_mode  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.tests.tiny_video import video_conf  # noqa: E402

pytestmark = pytest.mark.cuda

# the full-width cell's own limit, which the reference computed in fp8
# fails there: bf16 serving on the kernels has to hold to it at this size too
PIXEL_MAE = json.loads((ROOT / "benchmark/configs/skytimelapse_256.json").read_text())[
    "check"]["limits"]["pixel_mae"]


def test_served_clips_through_the_kernels_match_the_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.harness.session import Session
    from ddmi_tpu_torch.core import tracing
    from ddmi_tpu_torch.ops import attention, build, flash_attention

    build.build_all(build.LIBRARIES)
    # 64^2 x 8 frames: the decoder's finest cross-plane attention has 5,120
    # tokens of head dim 32, which the flash forward takes; the UNet's take
    # mha_vmem
    conf = video_conf(res=64, frames=8)
    sess = Session(tiny.cell(conf), 2147483659, "cuda")
    sess.warmup()
    launches = attention.mha_vmem.launches, flash_attention.flash_attention.launches
    rec = tracing.enable()
    try:
        window = sess.serve(1.0)
    finally:
        tracing.disable()
        sess.close()
    # each launch in its shape-named span (the cell's flash_roofline)
    names = [s[0] for s in rec.spans]
    for prefix, before, counter in (("kernels.mha_vmem/", launches[0], attention.mha_vmem),
                                    ("kernels.flash/", launches[1],
                                     flash_attention.flash_attention)):
        count = sum(n.startswith(prefix) for n in names)
        assert count == counter.launches - before > 0, prefix
    assert "kernels.flash/2x8x5120x32" in names  # service batch 2
    done = [r for r in window.records if r.error is None]
    assert done and len(done) == len(window.records)
    fp32_mode()
    models = check.reference_models(sess.domain, conf, sess.specs, 2147483659, "cuda")
    maes, ref = check.readings(sess.domain, conf, models, done[:3], sess.placed, Numerics(),
                               "cuda")
    assert max(maes) < PIXEL_MAE, maes
    assert min(float(x.astype(np.float32).std()) for x in ref) > 0.02 * 255


def _triplane_unet(conf, seed=0):
    """The config's TriplaneUNet on the card in bf16, with random output
    convolutions."""
    from ddmi_tpu_torch.core.config import config_from_dict
    from ddmi_tpu_torch.nn.unet_triplane import TriplaneUNet

    cfg = config_from_dict(conf["config"]).model.unetconfig
    torch.manual_seed(seed)
    u = TriplaneUNet(cfg).eval()
    with torch.no_grad():
        for p in u.parameters():
            if not p.any():
                p.normal_(0, 0.05)
    return u.to("cuda", torch.bfloat16)


def _noise(u, b, seed):
    n = sum(h * w for h, w in u.cfg.plane_sizes)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn((b, n, u.cfg.in_channels), generator=g, device="cuda"),
            torch.randint(0, 1000, (b,), generator=g, device="cuda"))


def test_triplane_graphs_replay_the_eager_forward():
    """At 64^2 x 8 frames (batch 4): the forward's first call at a key runs
    eagerly, the second captures it cut at its attention calls, the third
    replays; each is bit-identical to the eager forward (tolerance 0: the
    same kernels on the same inputs), launches the eager forward's
    attention kernels, records sampler.graphed 0, 1, 1 and one
    sampler.xattn span per cross-plane attention.  Two interleaved calls
    at the key return tensors of their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ddmi_tpu_torch.core import tracing
    from ddmi_tpu_torch.ops import attention, build, flash_attention

    build.build_all(build.LIBRARIES)
    u = _triplane_unet(video_conf(res=64, frames=8))
    (x, t), (x2, t2) = _noise(u, 4, 1), _noise(u, 4, 2)
    counters = (attention.mha_vmem, flash_attention.flash_attention)
    with torch.inference_mode():
        before = [c.launches for c in counters]
        ref = u(x, t, return_cache=True)[0]   # eager: an encoder cache is asked for
        per_forward = [c.launches - b for c, b in zip(counters, before)]
        ref2 = u(x2, t2, return_cache=True)[0]
        rec = tracing.enable()
        try:
            before = [c.launches for c in counters]
            outs = [u(x, t) for _ in range(3)]
            launched = [c.launches - b for c, b in zip(counters, before)]
            a, b = u(x, t), u(x2, t2)
            torch.cuda.synchronize()
        finally:
            tracing.disable()
    assert ref.abs().max().item() > 0.1 and sum(per_forward) > 0
    for out in outs:
        assert torch.equal(out, ref)
    assert launched == [3 * n for n in per_forward]
    graphed = [v for name, _, _, v, _ in rec.values if name == "sampler.graphed"]
    assert graphed == [0, 1, 1, 1, 1]
    cross = len(u.input_attns) + len(u.output_attns)   # input_attns[0] has none, + mid_attn
    assert [s[0] for s in rec.spans].count("sampler.xattn") == 5 * cross
    assert a.data_ptr() != b.data_ptr() and a.data_ptr() != outs[-1].data_ptr()
    assert torch.equal(a, ref) and torch.equal(b, ref2)


def test_graphed_triplane_ddim_matches_the_eager_loop():
    """10 DDIM steps with mixed prediction over triplane tokens at 64^2 x 8
    frames: `ddim_sample_unet` (the TriplaneUNet's graphs and the update's)
    against the eager loop of `_ddim_step` over the eager forward, bit for
    bit (tolerance 0), on its first call and on a second that replays
    throughout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ddmi_tpu_torch.diffusion import process
    from ddmi_tpu_torch.diffusion.schedule import ddim_times, make_schedule
    from ddmi_tpu_torch.ops import build

    build.build_all(build.LIBRARIES)
    u = _triplane_unet(video_conf(res=64, frames=8), seed=1)
    sched = make_schedule(beta_schedule="linear", timesteps=1000, linear_start=0.0015,
                          linear_end=0.0195, cosine_s=8e-3, v_posterior=0.0,
                          parameterization="eps")
    gd = process.GaussianDiffusion(schedule=sched, sampling_timesteps=10).to("cuda")
    noise, _ = _noise(u, 4, 3)
    g = torch.Generator(device="cuda").manual_seed(4)
    logit = -2.0 + 0.5 * torch.randn((1, 1, noise.shape[-1]), generator=g, device="cuda")
    eager = lambda z, t: u(z, t, return_cache=True)[0]
    with torch.inference_mode():
        img = noise
        for time, time_next in ddim_times(1000, 10).tolist():
            img = process._ddim_step(gd, gd.schedule, eager, logit, img, time, time_next, None)
        got = [process.ddim_sample_unet(gd, u, logit, noise.shape, noise=noise)
               for _ in range(2)]
        torch.cuda.synchronize()
    assert img.abs().max().item() > 0.1
    for out in got:
        assert torch.equal(out, img)
    assert len(u._graphs._forwards) == 1
