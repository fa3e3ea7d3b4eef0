"""Small configurations of the benchmark's two domains for the CPU tests:
the cells' structure (every block kind, the attention blocks, the HDBF taps,
the triplane mixing, the NeRF skips) at widths a test run can hold."""

import copy
import json
from pathlib import Path

from benchmark.harness.cell import Cell

BENCH = Path(__file__).resolve().parents[1]


def _load(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def image_conf(limit=0.01):
    c = _load("celebahq_256")
    p = c["config"]["model"]["params"]
    p["unetconfig"].update(image_size=8, in_channels=4, out_channels=4, model_channels=32,
                           channel_mult=[1, 2], attention_resolutions=[2], num_head_channels=16)
    p["ddconfig"].update(resolution=32, ch=32, ch_mult=[1, 2, 2], num_res_blocks=1, z_channels=8,
                         out_ch=8, hdbf_resolutions=[16, 8])
    p["mlpconfig"].update(ch=32, latent_dim=8)
    p["ddpmconfig"].update(image_size=8, channels=4, sampling_timesteps=4)
    c["config"]["model"]["embed_dim"] = 4
    c["serve"]["resolution"] = 16
    c["check"] = {"requests": 3, "limits": {"pixel_mae": limit}}
    return c


def nerf_conf(limit=0.01):
    c = _load("srn_cars")
    p = c["config"]["model"]["params"]
    p["unetconfig"].update(image_size=4, in_channels=12, out_channels=12, model_channels=32,
                           channel_mult=[1, 2], attention_resolutions=[2], num_head_channels=16)
    p["ddconfig"].update(resolution=16, ch=32, ch_mult=[1, 2, 2], num_res_blocks=1, z_channels=8,
                         out_ch=4, inter_attn_resolutions=[16, 8, 4])
    p["mlpconfig"].update(D=4, W=256, skips=[2], N_samples=8, multires=2, multires_views=1)
    p["ddpmconfig"].update(image_size=4, channels=12, sampling_timesteps=4)
    c["config"]["model"]["embed_dim"] = 4
    c["serve"] = {"resolution": 8, "n_views": 2}
    c["check"] = {"requests": 2, "limits": {"pixel_mae": limit}}
    return c


def traffic(batch=2, clients=4, trace_batches=1):
    return {"driver": "closed_loop_service", "service_batch": batch, "clients": clients, "n": 1,
            "linger_ms": 20.0, "timeout_s": 120, "trace_batches": trace_batches}


def cell(conf, name="tiny"):
    from benchmark.harness.cell import load
    real = load("celebahq_256.sample.b32")
    return Cell(name, 1, copy.deepcopy(conf), traffic(), real.end_to_end, real.per_layer)
