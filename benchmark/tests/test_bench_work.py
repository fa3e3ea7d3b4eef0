"""The work counts against hand counts at one small shape."""

import torch
from torch import nn

from benchmark.domains import image
from benchmark.tests import tiny
from benchmark.work import attention, flops, peaks


def test_attention_block_work_by_hand():
    b, c, n = 2, 64, 16
    # qkv 2 n c 3c, scores 2 n n c, probabilities times v 2 n n c, proj 2 n c c
    hand = b * (2 * 16 * 64 * 192 + 2 * 16 * 16 * 64 + 2 * 16 * 16 * 64 + 2 * 16 * 64 * 64)
    assert attention.block_flops(b, c, n) == hand
    # x in and out (b n c each), GroupNorm scale and shift, weights and biases
    nbytes = 2 * (2 * 2 * 16 * 64 + 2 * 64 + 3 * 64 * 64 + 3 * 64 + 64 * 64 + 64)
    assert attention.block_bytes(b, c, n) == nbytes


def test_peaks_and_least_time():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES == 3.35e12
    assert peaks.least_seconds(989e12, 0) == 1.0
    assert peaks.least_seconds(0, 3.35e12) == 1.0
    assert peaks.least_seconds(989e9, 3.35e12) == 1.0


def test_flop_counter_on_meta_by_hand():
    with torch.device("meta"):
        lin = nn.Linear(32, 48)
        conv = nn.Conv2d(8, 16, 3, padding=1)
        x, y = torch.empty(5, 32), torch.empty(2, 8, 10, 10)
    assert flops.count(lambda: lin(x)) == 2 * 5 * 32 * 48
    assert flops.count(lambda: conv(y)) == 2 * (2 * 16 * 10 * 10) * (8 * 9)


def test_image_sample_work_counts_every_stage():
    conf = tiny.image_conf()
    with torch.device("meta"):
        models = image.reference_models(conf)
    w = image.sample_work(conf, models)
    u = conf["config"]["model"]["params"]["unetconfig"]
    d = conf["config"]["model"]["params"]["ddpmconfig"]
    # the stem conv alone, once per step, is a lower bound of the denoiser
    stem = 2 * u["model_channels"] * d["image_size"] ** 2 * u["in_channels"] * 9
    assert w["denoiser"] > stem * d["sampling_timesteps"]
    # the render's products: at least the final toRGB, 2 n ch out_ch a token
    res, m = conf["serve"]["resolution"], conf["config"]["model"]["params"]["mlpconfig"]
    assert w["render"] > 2 * res * res * m["ch"] * m["out_ch"]
    assert w["decoder"] > 0 and w["render_bytes"] > 0
