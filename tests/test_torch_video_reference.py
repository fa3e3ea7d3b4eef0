"""The port's video sampling path against the benchmark's plain reference
(benchmark/reference/: triplane_unet.py, video_decoder.py, inr_video.py,
ddim.py), on the CPU in float32 at a small size (benchmark/tests/
tiny_video.py: 32^2, 4 frames, model_channels 32), on weights drawn by
benchmark/harness/weights.py: the TriplaneUNet, the video decoder, the INR
of each frame, the DDIM over triplane tokens with mixed prediction, and the
whole served path through SamplerService against
benchmark/domains/video.py::reference; and the spans the cell's readers
read (core/tracing.py): one `sampler.xattn` per cross-plane attention of a
UNet forward, one `decoder.xattn` per cross-plane attention of a decode,
and the kernels' shape-named spans.  The same comparison through the card's
kernels is tests/test_torch_video_reference_cuda.py."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from benchmark.domains import video  # noqa: E402
from benchmark.harness import check, weights  # noqa: E402
from benchmark.reference.ddim import Schedule, ddim_sample  # noqa: E402
from benchmark.reference.numerics import Numerics  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.tests.tiny_video import video_conf  # noqa: E402


def _cfg(conf):
    from ddmi_tpu_torch.core.config import config_from_dict

    return config_from_dict(conf["config"])


@pytest.fixture(scope="module")
def setup():
    """(conf, the reference modules, the port's VideoPipeline) on the same
    float32 weights."""
    from ddmi_tpu_torch.domains.video import VideoPipeline

    torch.set_num_threads(2)
    conf = video_conf()
    with torch.device("meta"):
        meta = video.reference_models(conf)
    specs = weights.model_specs(meta, video.program_keys(_cfg(conf)), conf["init"]["rules"])
    models = check.reference_models(video, conf, specs, 7, "cpu")
    sds = weights.state_dicts(specs, 7, "cpu", torch.bfloat16, conf["init"],
                              conf["config"]["model"]["params"]["ddpmconfig"]["channels"])
    sds = {k: {n: t.float() for n, t in v.items()} if isinstance(v, dict) else v
           for k, v in sds.items()}
    pipe = VideoPipeline(_cfg(conf), device="cpu")
    pipe.load_state_dicts(**sds)
    return conf, models, pipe


def _close(got, ref, tol=2e-4):
    """Max |got - ref| over max |ref|.  2e-4: both sides compute in float32
    and differ only in the order of their sums (the port stacks the time
    planes on the batch, samples the planes through interpolation matrices,
    fuses its projections), which moves values by a few float32 ulps per
    layer over a few dozen layers."""
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-6)
    assert err < tol, err


def _tokens(conf, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b,) + video.noise_shape(conf), generator=g)


def test_triplane_unet_matches_the_reference(setup):
    conf, models, pipe = setup
    x, t = _tokens(conf, 2), torch.tensor([999, 17])
    with torch.no_grad():
        _close(pipe.unet(x, t), models["unet"](x, t))


def test_video_decoder_and_inr_match_the_reference(setup):
    conf, models, pipe = setup
    z = _tokens(conf, 2, seed=1)
    with torch.no_grad():
        port, ref = pipe.vae.decode(z), models["vae"](z)
        for port_pyramid, ref_pyramid in zip(port, ref):
            assert len(port_pyramid) == len(ref_pyramid) == 3
            for a, b in zip(port_pyramid, ref_pyramid):
                _close(a, b)
        frames, res = video.frames(conf), video.resolution(conf)
        for f in range(frames):
            _close(pipe.render(ref, f), models["mlp"](ref, f, frames, res))


def test_ddim_over_triplane_tokens_matches_the_reference(setup):
    from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet

    conf, models, pipe = setup
    d = conf["config"]["model"]["params"]["ddpmconfig"]
    gd = GaussianDiffusion.from_config(_cfg(conf).model.ddpmconfig)
    x = _tokens(conf, 2, seed=2)
    logit = models["mixing_logit"].reshape(1, 1, -1)
    assert torch.equal(pipe.mixing_logit.detach(), logit)
    with torch.no_grad():
        got = ddim_sample_unet(gd, pipe.unet, pipe.mixing_logit, x.shape, noise=x)
        sched = Schedule(d["timesteps"], d["linear_start"], d["linear_end"])
        ref = ddim_sample(lambda a, t: models["unet"](a, t), sched, logit, x,
                          d["sampling_timesteps"])
    _close(got, ref)


def test_served_clips_match_the_reference():
    """The service on the CPU, float32, against the reference: every pixel
    of the checked clips equal to within one level of 255 (a value that
    lands within float32 rounding of a level's edge may round to either)."""
    from benchmark.harness.session import Session

    torch.set_num_threads(2)
    conf = video_conf()
    sess = Session(tiny.cell(conf), 11, "cpu")
    sess.warmup()
    window = sess.serve(0.5)
    sess.close()
    done = [r for r in window.records if r.error is None]
    assert done and len(done) == len(window.records)
    frames, res = video.frames(conf), video.resolution(conf)
    assert done[0].result.shape == (1, frames, res, res, 3)
    models = check.reference_models(sess.domain, conf, sess.specs, 11, "cpu")
    maes, ref = check.readings(sess.domain, conf, models, done[:3], sess.placed, Numerics(),
                               "cpu")
    for r, x in zip(done[:3], ref):
        assert np.abs(r.result[0].astype(int) - x.astype(int)).max() <= 1
    assert max(maes) < 1e-3
    # the check sees clips: not flat, and changing from frame to frame
    for x in ref:
        x = x.astype(np.float32)
        assert x.std() > 0.02 * 255
        assert np.abs(np.diff(x, axis=0)).mean() > 0.002 * 255


def test_cross_plane_and_kernel_spans(setup):
    from ddmi_tpu_torch.core import tracing

    conf, _, pipe = setup
    assert tracing.shape_span("kernels.flash", (2, 8, 5120, 32)) is tracing.OFF
    rec = tracing.enable()
    try:
        with tracing.shape_span("kernels.flash", torch.Size([2, 8, 5120, 32])):
            pass
        with torch.no_grad():
            pipe.unet(_tokens(conf, 1), torch.tensor([5]))
            pipe.vae.decode(_tokens(conf, 1))
    finally:
        tracing.disable()
    names = [s[0] for s in rec.spans]
    assert names[0] == "kernels.flash/2x8x5120x32"
    unet, decoder = pipe.unet, pipe.vae.decoder
    assert names.count("sampler.xattn") == len(unet.input_attns) + len(unet.output_attns)
    assert names.count("decoder.xattn") == 1 + sum(lvl.inter_attn is not None
                                                   for lvl in decoder.up)
