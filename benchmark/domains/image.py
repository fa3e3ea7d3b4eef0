"""The image domain: DDIM over the ADM UNet, the D2C-VAE decoder's HDBF
pyramid and the scale-aware INR rendered on a regular grid."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.adm_unet import UNet
from benchmark.reference.ddim import Schedule, ddim_sample
from benchmark.reference.inr_image import INRImage
from benchmark.reference.ldm_decoder import ImageDecoder
from benchmark.reference.numerics import Numerics

# range name -> (owner below the pipeline, method)
SPANS = {
    "sampler.sample_latents": ("", "sample_latents"),
    "render.decode": ("", "decode_latents"),
    "decoder.decode": ("vae", "decode"),
    "render.render": ("", "_render_grid"),
}


def params(conf):
    return conf["config"]["model"]["params"]


def resolution(conf) -> int:
    return int(conf["serve"]["resolution"])


def service_kwargs(conf) -> dict:
    return {"resolution": resolution(conf)}


def noise_shape(conf):
    """One sample's initial latent as the service draws it (NHWC)."""
    d = params(conf)["ddpmconfig"]
    return (d["image_size"], d["image_size"], d["channels"])


def reference_models(conf) -> dict:
    p = params(conf)
    return {"unet": UNet(p["unetconfig"]),
            "vae": ImageDecoder(p["ddconfig"], conf["config"]["model"]["embed_dim"]),
            "mlp": INRImage(p["mlpconfig"])}


def program_keys(cfg) -> dict:
    """(key, shape) of every tensor the program's modules load, by module:
    the VAE's encoder half is loaded with its decoder, though sampling does
    not run it."""
    from ddmi_tpu_torch.nn.vae import Autoencoder

    with torch.device("meta"):
        vae = Autoencoder(cfg.model.ddconfig, embed_dim=cfg.model.embed_dim)
    return {"vae": [(k, tuple(v.shape)) for k, v in vae.state_dict().items()]}


def latents(conf, seeds, device):
    """The service's initial latents of requests of n = 1: one numpy draw
    per seed, NHWC, laid out NCHW."""
    rows = [np.random.default_rng(s).standard_normal((1,) + noise_shape(conf), dtype=np.float32)
            for s in seeds]
    return torch.from_numpy(np.concatenate(rows)).permute(0, 3, 1, 2).to(device)


def sample_latents(models, conf, seeds, nx: Numerics, device):
    d = params(conf)["ddpmconfig"]
    sched = Schedule(d["timesteps"], d["linear_start"], d["linear_end"], device)
    unet = models["unet"]
    return ddim_sample(lambda x, t: unet(x, t, nx), sched, models["mixing_logit"],
                       latents(conf, seeds, device), d["sampling_timesteps"])


def anchor_scale(conf) -> float:
    return params(conf)["ddconfig"]["resolution"] / resolution(conf)


def render(models, conf, z1, batch_seed: int, position: int, nx: Numerics):
    """One sample's latent (1, C, h, w) -> its pixels (res, res, 3) in
    [0, 1], float32."""
    res = resolution(conf)
    hdbf = models["vae"](z1, nx)
    rgb = models["mlp"](hdbf, res, anchor_scale(conf), batch_seed, position, nx)
    return (rgb.reshape(res, res, -1).clamp(-1.0, 1.0) + 1.0) / 2.0


def reference(models, conf, requests, nx: Numerics, device) -> list:
    """The served uint8 images of `requests` (seed, batch_seed, position),
    worked out again by the plain reference."""
    z = sample_latents(models, conf, [r.seed for r in requests], nx, device)
    out = []
    for i, r in enumerate(requests):
        img = render(models, conf, z[i : i + 1], r.batch_seed, r.position, nx)
        out.append((img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy())
    return out


def sample_work(conf, models) -> dict:
    """FLOPs of one sample through the reference, by stage (the models on
    the meta device): `denoiser` (one forward times the steps), `decoder`,
    `render`; and the bytes the render reads and writes at least, bf16
    planes, weights and pixels."""
    from benchmark.work.flops import count

    p = params(conf)
    d, u = p["ddpmconfig"], p["unetconfig"]
    res = resolution(conf)
    x = torch.empty((1, u["in_channels"], d["image_size"], d["image_size"]), device="meta")
    t = torch.zeros((1,), dtype=torch.long, device="meta")
    unet = count(lambda: models["unet"](x, t)) * d["sampling_timesteps"]
    with torch.no_grad():
        hdbf = models["vae"](torch.empty((1, d["channels"], d["image_size"], d["image_size"]),
                                         device="meta"))
    decoder = count(lambda: models["vae"](torch.empty(
        (1, d["channels"], d["image_size"], d["image_size"]), device="meta")))
    render_flops = count(lambda: models["mlp"](hdbf, res, anchor_scale(conf), 0, 0))
    read = sum(h.numel() for h in hdbf) + sum(w.numel() for w in models["mlp"].parameters())
    written = res * res * p["mlpconfig"]["out_ch"]
    return {"denoiser": unet, "decoder": decoder, "render": render_flops,
            "render_bytes": 2 * (read + written)}
