"""The plain reference against the port at small widths on the CPU (float32
both): every module of the two sampling paths, the DDIM loop with mixed
prediction, the render noise and the whole served path through
SamplerService."""

import numpy as np
import pytest
import torch

from benchmark.domains import image, nerf
from benchmark.harness import check, weights
from benchmark.reference import philox
from benchmark.reference.adm_unet import UNet as RefUNet
from benchmark.reference.ddim import Schedule, ddim_sample
from benchmark.reference.numerics import Numerics
from benchmark.tests import tiny

torch.set_num_threads(2)


def _cfg(conf):
    from ddmi_tpu_torch.core.config import config_from_dict

    return config_from_dict(conf["config"])


def _weights(dom, conf, seed=7):
    """The reference modules and, by module, the same weights in float32."""
    with torch.device("meta"):
        meta = dom.reference_models(conf)
    specs = weights.model_specs(meta, dom.program_keys(_cfg(conf)), conf["init"]["rules"])
    models = check.reference_models(dom, conf, specs, seed, "cpu")
    sds = {k: {n: t.float() for n, t in v.items()} if isinstance(v, dict) else v
           for k, v in weights.state_dicts(specs, seed, "cpu", torch.bfloat16, conf["init"],
                                           conf["config"]["model"]["params"]["ddpmconfig"][
                                               "channels"]).items()}
    return models, sds


def _close(a, b, tol=2e-4):
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all()
    err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)
    assert err < tol, err


@pytest.mark.parametrize("dom,make", [(image, tiny.image_conf), (nerf, tiny.nerf_conf)])
def test_unet_matches_the_port(dom, make):
    from ddmi_tpu_torch.nn.unet import UNet

    conf = make()
    models, sds = _weights(dom, conf)
    port = UNet(_cfg(conf).model.unetconfig)
    port.load_state_dict(sds["unet"], strict=True)
    u = conf["config"]["model"]["params"]["unetconfig"]
    x = torch.randn(2, u["in_channels"], u["image_size"], u["image_size"])
    t = torch.tensor([999, 17])
    with torch.no_grad():
        _close(models["unet"](x, t), port(x, t))


def test_image_decoder_and_render_match_the_port():
    from ddmi_tpu_torch.domains.image import ImagePipeline

    conf = tiny.image_conf()
    models, sds = _weights(image, conf)
    pipe = ImagePipeline(_cfg(conf), device="cpu")
    pipe.load_state_dicts(**sds)
    d = conf["config"]["model"]["params"]["ddpmconfig"]
    z = torch.randn(2, d["channels"], d["image_size"], d["image_size"])
    res = image.resolution(conf)
    with torch.no_grad():
        hdbf = pipe.vae.decode(z)
        for mine, port in zip(models["vae"](z), hdbf):
            _close(mine, port)
        # the port's fused render (its plain version on the CPU), noise keyed
        # by the batch's seed and each sample's place in the batch
        out = pipe._render_grid(hdbf, res, image.anchor_scale(conf), 1234)
        for pos in range(2):
            ref = models["mlp"]([h[pos : pos + 1] for h in hdbf], res,
                                image.anchor_scale(conf), 1234, pos)
            _close(ref, out[pos], tol=1e-3)


def test_render_noise_matches_the_port():
    from ddmi_tpu_torch.ops.inr_decode import philox_normal

    port = philox_normal(3000000123, 700)
    assert torch.equal(philox.noise(3000000123, 0, 700, 12), port)
    assert torch.equal(philox.noise(3000000123, 300, 400, 12), port[300:])


def test_triplane_decoder_and_nerf_render_match_the_port():
    from ddmi_tpu_torch.domains.nerf import NeRFPipeline

    conf = tiny.nerf_conf()
    models, sds = _weights(nerf, conf)
    pipe = NeRFPipeline(_cfg(conf), device="cpu")
    pipe.load_state_dicts(**sds)
    d = conf["config"]["model"]["params"]["ddpmconfig"]
    z = torch.randn(1, d["channels"], d["image_size"], d["image_size"])
    with torch.no_grad():
        planes = pipe.decode_planes(z)
        mine = models["vae"](z)
        for k in ("xy", "yz", "xz"):
            _close(mine[k], planes[k])
        port = pipe.render_nerfs(z, conf["serve"]["n_views"], 8, 8)[0]
        _close(nerf.render(models, conf, z, Numerics()), port, tol=1e-3)


def test_ddim_with_mixed_prediction_matches_the_port():
    from ddmi_tpu_torch.diffusion.process import GaussianDiffusion, ddim_sample_unet
    from ddmi_tpu_torch.nn.unet import UNet

    conf = tiny.image_conf()
    models, sds = _weights(image, conf)
    cfg = _cfg(conf)
    port = UNet(cfg.model.unetconfig)
    port.load_state_dict(sds["unet"])
    d = conf["config"]["model"]["params"]["ddpmconfig"]
    gd = GaussianDiffusion.from_config(cfg.model.ddpmconfig)
    x = torch.randn(2, d["channels"], d["image_size"], d["image_size"])
    with torch.no_grad():
        got = ddim_sample_unet(gd, port, sds["mixing_logit"], x.shape, noise=x)
        sched = Schedule(d["timesteps"], d["linear_start"], d["linear_end"])
        ref = ddim_sample(lambda a, t: models["unet"](a, t), sched, models["mixing_logit"], x,
                          d["sampling_timesteps"])
    _close(ref, got)


@pytest.mark.parametrize("make", [tiny.image_conf, tiny.nerf_conf])
def test_served_requests_match_the_reference(make):
    """The service on the CPU, float32, against the reference: every pixel of
    the checked requests equal to within one level of 255."""
    from benchmark.harness.session import Session

    conf = make()
    sess = Session(tiny.cell(conf), 11, "cpu")
    sess.warmup()
    window = sess.serve(0.5)
    sess.close()
    done = [r for r in window.records if r.error is None]
    assert done and len(done) == len(window.records)
    models = check.reference_models(sess.domain, conf, sess.specs, 11, "cpu")
    maes, ref = check.readings(sess.domain, conf, models, done[:3], sess.placed, Numerics(),
                               "cpu")
    for r, x in zip(done[:3], ref):
        assert np.abs(r.result[0].astype(int) - x.astype(int)).max() <= 1
    assert max(maes) < 1e-3
    # the check sees the images: not flat, not saturated
    assert min(float(x.std()) for x in ref) > 0.02 * 255
