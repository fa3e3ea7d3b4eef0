"""A small configuration of the video domain for the CPU tests: every block
kind of the cell's (the per-plane ResBlocks and attention blocks, the
cross-plane attentions of the UNet and of the decoder, the HDBF taps, the
time planes' width-only upsampling, the per-frame INR) at widths a test run
can hold: 32^2, 4 frames, model_channels 32."""

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def video_conf(limit=0.01, res=32, frames=4, ch=32):
    """The video configuration at `res`^2 x `frames` (res a multiple of 8):
    the UNet at model_channels `ch`, two levels, attention at ds 2; the
    decoder over four levels from res / 8 up, every level with its
    cross-plane attention, taps at res / 4 and res / 2."""
    c = json.loads((BENCH / "configs" / "skytimelapse_256.json").read_text())
    p = c["config"]["model"]["params"]
    r = res // 8
    p["unetconfig"].update(in_channels=8, out_channels=8, model_channels=ch, channel_mult=[1, 2],
                           attention_resolutions=[2], num_res_blocks=1, num_head_channels=16,
                           plane_sizes=[[r, r], [frames, r], [frames, r]])
    p["ddconfig"].update(resolution=res, ch=32, ch_mult=[1, 1, 2, 2], num_res_blocks=1,
                         z_channels=8, out_ch=8, timesformer_channels=64,
                         hdbf_resolutions=[res // 4, res // 2],
                         inter_attn_resolutions=[r, 2 * r, res // 2, res])
    p["mlpconfig"].update(ch=32, latent_dim=8)
    p["ddpmconfig"].update(channels=8, sampling_timesteps=4)
    c["config"]["model"]["embed_dim"] = 8
    c["config"]["data"]["frames"] = frames
    c["check"] = {"requests": 3, "limits": {"pixel_mae": limit}}
    return c
