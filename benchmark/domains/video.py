"""The video domain: DDIM over the triplane UNet on the [xy | xt | yt]
latent tokens, the video decoder's triplane HDBF pyramids and the video
INR rendered one frame at a time, a clip of `data.frames` frames at the
VAE's resolution per request."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.domains.image import params
from benchmark.reference.ddim import Schedule, ddim_sample
from benchmark.reference.inr_video import INRVideo
from benchmark.reference.numerics import Numerics
from benchmark.reference.triplane_unet import TriplaneUNet
from benchmark.reference.video_decoder import VideoDecoder

SPANS = {
    "sampler.sample_latents": ("", "sample_latents"),
    "render.decode": ("", "decode_videos"),
    "decoder.decode": ("vae", "decode"),
    "render.render": ("", "render"),
}


def service_kwargs(conf) -> dict:
    return {}


def frames(conf) -> int:
    return int(conf["config"]["data"]["frames"])


def resolution(conf) -> int:
    return int(params(conf)["ddconfig"]["resolution"])


def plane_sizes(conf):
    """The latent planes' (h, w): xy (r, r), xt and yt (frames, r), r the
    resolution over 8."""
    r = resolution(conf) // 8
    return [(r, r), (frames(conf), r), (frames(conf), r)]


def noise_shape(conf):
    """One sample's initial latent as the service draws it: tokens by
    channels."""
    return (sum(h * w for h, w in plane_sizes(conf)), params(conf)["ddpmconfig"]["channels"])


def reference_models(conf) -> dict:
    p = params(conf)
    u = dict(p["unetconfig"], plane_sizes=p["unetconfig"].get("plane_sizes") or plane_sizes(conf))
    return {"unet": TriplaneUNet(u),
            "vae": VideoDecoder(p["ddconfig"], conf["config"]["model"]["embed_dim"],
                                frames(conf)),
            "mlp": INRVideo(p["mlpconfig"])}


def program_keys(cfg) -> dict:
    """The video pipeline loads the decode half of its VAE alone."""
    return {}


def latents(conf, seeds, device):
    """The service's initial latents of requests of n = 1: one numpy draw
    per seed."""
    rows = [np.random.default_rng(s).standard_normal((1,) + noise_shape(conf), dtype=np.float32)
            for s in seeds]
    return torch.from_numpy(np.concatenate(rows)).to(device)


def render(models, conf, z1, nx: Numerics):
    """One sample's latent tokens (1, n, C) -> its clip (frames, res, res,
    out_ch) in [0, 1], float32."""
    res, t = resolution(conf), frames(conf)
    hdbf = models["vae"](z1, nx)
    clip = torch.stack([models["mlp"](hdbf, f, t, res, nx)[0] for f in range(t)])
    return (clip.reshape(t, res, res, -1).clamp(-1.0, 1.0) + 1.0) / 2.0


def reference(models, conf, requests, nx: Numerics, device) -> list:
    """The served uint8 clips of `requests`, worked out again by the plain
    reference; the mixing logit drawn as (1, C, 1, 1) is the tokens'
    (1, 1, C)."""
    d = params(conf)["ddpmconfig"]
    sched = Schedule(d["timesteps"], d["linear_start"], d["linear_end"], device)
    unet = models["unet"]
    z = ddim_sample(lambda x, t: unet(x, t, nx), sched, models["mixing_logit"].reshape(1, 1, -1),
                    latents(conf, [r.seed for r in requests], device), d["sampling_timesteps"])
    return [(render(models, conf, z[i : i + 1], nx).clamp(0.0, 1.0) * 255.0)
            .to(torch.uint8).cpu().numpy() for i in range(len(requests))]


def sample_work(conf, models) -> dict:
    """FLOPs of one sample through the reference, by stage (the models on
    the meta device): `denoiser` (one forward times the steps), `decoder`,
    `render` (every frame); and the bytes the render reads and writes at
    least: the bf16 pyramids and weights once, the bf16 pixels."""
    from benchmark.work.flops import count

    p = params(conf)
    d, m = p["ddpmconfig"], p["mlpconfig"]
    res, t = resolution(conf), frames(conf)
    x = torch.empty((1,) + noise_shape(conf), device="meta")
    step = torch.zeros((1,), dtype=torch.long, device="meta")
    unet = count(lambda: models["unet"](x, step)) * d["sampling_timesteps"]
    decoder = count(lambda: models["vae"](x))
    with torch.no_grad():
        hdbf = models["vae"](x)
    render_flops = count(lambda: models["mlp"](hdbf, 0, t, res)) * t
    read = sum(h.numel() for pyramid in hdbf for h in pyramid) + sum(
        w.numel() for w in models["mlp"].parameters())
    return {"denoiser": unet, "decoder": decoder, "render": render_flops,
            "render_bytes": 2 * (read + t * res * res * m["out_ch"])}
