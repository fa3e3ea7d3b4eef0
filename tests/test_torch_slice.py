"""The ported image-generation slice as a whole, against the JAX package:
`ImagePipeline.sample_images` at NFE 4, batch 2, a tiny config, with the
same weights (converted by ddmi_tpu_torch/interop.py) and the same initial
noise; and the port's `SamplerService` coalescing concurrent requests.

Final pixels in [0, 1] must agree within 1e-3 after 4 DDIM steps: fp32 on
both sides, but sums run in different orders through ~30 layers per step.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from ddmi_tpu.core.config import config_from_dict
from ddmi_tpu_torch.interop import mlp_image_from_jax, unet_from_jax, vae_from_jax

torch.set_num_threads(1)

CFG = {
    "model": {
        "use_fp16": False, "embed_dim": 4,
        "params": {
            "unetconfig": dict(image_size=4, in_channels=4, model_channels=32,
                               out_channels=4, attention_resolutions=[2],
                               num_res_blocks=1, channel_mult=[1, 2],
                               num_head_channels=32),
            "ddconfig": dict(z_channels=8, resolution=16, out_ch=8, ch=32,
                             ch_mult=[1, 1, 2], num_res_blocks=1,
                             hdbf_resolutions=[8, 4], attn_type="vanilla"),
            "mlpconfig": dict(ch=32, latent_dim=8),
            "ddpmconfig": dict(image_size=4, channels=4, sampling_timesteps=4),
        },
    },
    "data": {"domain": "image", "test_resolution": 16},
}


def _perturb_zeros(tree, rng, skip=("noise",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = v if k in skip else _perturb_zeros(v, rng, skip)
        else:
            a = np.asarray(v)
            out[k] = (0.05 * rng.standard_normal(a.shape)).astype(np.float32) if not a.any() else a
    return out


@pytest.fixture(scope="module")
def shared():
    """JAX pipeline + params (zero-init leaves perturbed, mixing logit
    random so the UNet carries weight in the prediction) and the port
    state_dicts made from them."""
    from ddmi_tpu.domains.image import ImagePipeline

    cfg = config_from_dict(CFG)
    pipe = ImagePipeline(cfg)
    rng = np.random.default_rng(0)
    s1 = _perturb_zeros(pipe.init_stage1_params(jax.random.PRNGKey(0)), rng)
    s2 = pipe.init_stage2_params(jax.random.PRNGKey(1))
    s2 = {"unet": _perturb_zeros(s2["unet"], rng),
          "mixing_logit": rng.standard_normal((1, 1, 1, 4)).astype(np.float32)}
    m = cfg.model
    sds = {
        "unet": unet_from_jax(s2["unet"], m.unetconfig),
        "vae": vae_from_jax(s1["vae"], m.ddconfig),
        "mlp": mlp_image_from_jax(s1["mlp"], m.mlpconfig),
        "mixing_logit": torch.from_numpy(np.transpose(s2["mixing_logit"], (0, 3, 1, 2))),
    }
    return cfg, pipe, s1, s2, sds


def test_sample_images_matches_jax(shared):
    from ddmi_tpu_torch.domains.image import ImagePipeline

    cfg, jpipe, s1, s2, sds = shared
    noise = np.random.default_rng(1).standard_normal((2, 4, 4, 4)).astype(np.float32)
    ref = jpipe.sample_images(s2, s1, jax.random.PRNGKey(2), batch=2, resolution=16,
                              noise=jax.numpy.asarray(noise))
    pipe = ImagePipeline(cfg, device="cpu")
    pipe.load_state_dicts(**sds)
    got = pipe.sample_images(
        2, 16, noise=torch.from_numpy(np.ascontiguousarray(np.transpose(noise, (0, 3, 1, 2))))
    )
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2, 16, 16, 3)
    assert float(ref.std()) > 1e-3  # the comparison sees a non-constant image
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-3


def test_service_coalesces_concurrent_requests(shared):
    from ddmi_tpu_torch.serve.server import SamplerService

    cfg, _, _, _, sds = shared
    svc = SamplerService(cfg, service_batch=4, resolution=16, linger_ms=500,
                         device="cpu", state_dicts=sds)
    batches = []
    run = svc.pipe.sample_images

    def counting(*a, **k):
        batches.append(k.get("render_seed"))
        return run(*a, **k)

    svc.pipe.sample_images = counting
    results = {}
    try:
        threads = [
            threading.Thread(target=lambda s=s, n=n: results.__setitem__(s, svc.generate(n, seed=s)))
            for s, n in ((11, 1), (12, 1), (13, 2))
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        solo = svc.generate(1, seed=12)
    finally:
        svc.close()
    assert len(batches) == 2, batches  # the three requests shared one batch
    assert {s: r.shape for s, r in results.items()} == {
        11: (1, 16, 16, 3), 12: (1, 16, 16, 3), 13: (2, 16, 16, 3)}
    assert all(r.dtype == np.uint8 for r in results.values())
    # the initial latent is per request; with no render noise (gains 0) a
    # seed reproduces its sample wherever it sits in a batch
    assert np.array_equal(results[12], solo)


def test_render_grid_under_autograd_runs_the_inr_module():
    """`ImagePipeline._render_grid` with a gradient recorded renders through
    the INRImage module (the fused render has no gradient): its output has a
    grad_fn, gradients reach the MLP, and it equals the module's output
    and, within 1e-4 * max(1, max|ref|), the fused render's plain version."""
    from ddmi_tpu_torch.core.config import config_from_dict as torch_config
    from ddmi_tpu_torch.domains.image import ImagePipeline
    from ddmi_tpu_torch.ops.resample import pixel_center_lin

    pipe = ImagePipeline(torch_config(CFG), device="cpu", seed=3)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for name, p in pipe.mlp.named_parameters():
            if not p.any() and ".noise." not in name:
                p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    hdbf = [torch.from_numpy(rng.standard_normal((2, 8, r, r)).astype(np.float32))
            for r in (4, 8, 16)]
    out = pipe._render_grid(hdbf, 12, 0.7, 0)
    assert out.grad_fn is not None and out.shape == (2, 144, 3)
    out.square().sum().backward()
    assert all(p.grad is not None for p in pipe.mlp.parameters() if p.requires_grad)
    lin = pixel_center_lin(12)
    with torch.no_grad():
        ref = pipe.mlp(hdbf, 0.7, grid_1d=(lin, lin))
        fused = pipe._render_grid(hdbf, 12, 0.7, 0)
    assert fused.grad_fn is None
    assert torch.equal(out.detach(), ref)
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    assert (fused - ref).abs().max().item() <= tol
