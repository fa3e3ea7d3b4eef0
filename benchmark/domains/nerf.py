"""The NeRF domain: DDIM over the ADM UNet on triplane latents, the
triplane decoder and a volume render of a spherical camera path through
the NeRF MLP."""

from __future__ import annotations

import torch

from benchmark.domains.image import latents, params
from benchmark.reference.adm_unet import UNet
from benchmark.reference.ddim import Schedule, ddim_sample
from benchmark.reference.ldm_decoder import TriplaneDecoder
from benchmark.reference.nerf import NeRFMLP, poses, rays, render_rays
from benchmark.reference.numerics import Numerics

SPANS = {
    "sampler.sample_latents": ("", "sample_latents"),
    "render.decode": ("", "render_nerfs"),
    "decoder.decode": ("", "decode_planes"),
    "render.render": ("", "render_image"),
}
RAY_CHUNK = 4096


def service_kwargs(conf) -> dict:
    return {"resolution": int(conf["serve"]["resolution"]), "n_views": int(conf["serve"]["n_views"])}


def noise_shape(conf):
    d = params(conf)["ddpmconfig"]
    return (d["image_size"], d["image_size"], d["channels"])


def mlp_dims(conf):
    p = params(conf)
    m = p["mlpconfig"]
    in_xyz = 3 * p["ddconfig"]["out_ch"] + 3 * (2 * m["multires"] + 1)
    return m["D"], m["W"], in_xyz, 3 * (2 * m["multires_views"] + 1), m["skips"]


def reference_models(conf) -> dict:
    p = params(conf)
    return {"unet": UNet(p["unetconfig"]),
            "vae": TriplaneDecoder(p["ddconfig"], conf["config"]["model"]["embed_dim"]),
            "mlp": NeRFMLP(*mlp_dims(conf))}


def program_keys(cfg) -> dict:
    """The NeRF pipeline loads the decode half of its VAE alone."""
    return {}


def render(models, conf, z1, nx: Numerics):
    """One scene's latent (1, C, r, r) -> its views (n_views, H, W, 3),
    float32, not clipped."""
    m, s = params(conf)["mlpconfig"], conf["serve"]
    planes = models["vae"](z1, nx)
    res, views = int(s["resolution"]), []
    for c2w in torch.from_numpy(poses(int(s["n_views"]))).to(z1.device):
        o, d = rays(res, res, c2w)
        rgb = [render_rays(models["mlp"], planes, o[k : k + RAY_CHUNK], d[k : k + RAY_CHUNK],
                           m["N_samples"], m["multires"], m["multires_views"], nx)
               for k in range(0, o.shape[0], RAY_CHUNK)]
        views.append(torch.cat(rgb).reshape(res, res, 3))
    return torch.stack(views)


def reference(models, conf, requests, nx: Numerics, device) -> list:
    d = params(conf)["ddpmconfig"]
    sched = Schedule(d["timesteps"], d["linear_start"], d["linear_end"], device)
    unet = models["unet"]
    z = ddim_sample(lambda x, t: unet(x, t, nx), sched, models["mixing_logit"],
                    latents(conf, [r.seed for r in requests], device), d["sampling_timesteps"])
    return [(render(models, conf, z[i : i + 1], nx).clamp(0.0, 1.0) * 255.0)
            .to(torch.uint8).cpu().numpy() for i in range(len(requests))]


def sample_work(conf, models) -> dict:
    from benchmark.work.flops import count

    p = params(conf)
    d, u, s = p["ddpmconfig"], p["unetconfig"], conf["serve"]
    x = torch.empty((1, u["in_channels"], d["image_size"], d["image_size"]), device="meta")
    t = torch.zeros((1,), dtype=torch.long, device="meta")
    unet = count(lambda: models["unet"](x, t)) * d["sampling_timesteps"]
    z = torch.empty((1, d["channels"], d["image_size"], d["image_size"]), device="meta")
    decoder = count(lambda: models["vae"](z))
    with torch.no_grad():
        planes = models["vae"](z)
    m = p["mlpconfig"]
    res, n_views = int(s["resolution"]), int(s["n_views"])
    o = torch.empty((RAY_CHUNK, 3), device="meta")
    chunk = count(lambda: render_rays(models["mlp"], planes, o, o, m["N_samples"], m["multires"],
                                      m["multires_views"]))
    read = sum(v.numel() for v in planes.values()) + sum(
        w.numel() for w in models["mlp"].parameters())
    return {"denoiser": unet, "decoder": decoder,
            "render": chunk * n_views * res * res // RAY_CHUNK,
            "render_bytes": 2 * read + 4 * n_views * res * res * 3}
