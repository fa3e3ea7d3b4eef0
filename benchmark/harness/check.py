"""The output check: a sample of the requests answered in the window, drawn
from the run's seed and spread over the places of a service batch, worked
out again by the plain reference (float32, TF32 off) from the same seeds and
weights, and compared pixel by pixel.

The number compared is `pixel_mae`: for each sampled request the mean
absolute difference of its served uint8 pixels from the reference's, in
units of the full scale 255, and the largest over the sample.  Its limit is
the configuration's (`check.limits.pixel_mae`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.harness import weights


@dataclasses.dataclass(frozen=True)
class Request:
    seed: int
    batch_seed: int      # the first seed of the batch that served it
    position: int        # its first sample's place in that batch


def choose(done, k: int, seed: int, placed: dict):
    """k answered requests drawn from the seed (all if fewer): the i-th
    among those served at place (i * batch) // k of their batch, where any
    was, so that every part of a batch is checked and a fault in one half
    of it cannot go unseen."""
    if len(done) <= k:
        return list(done)
    rng = np.random.default_rng([int(seed) % 2**64 >> 32, int(seed) % 2**32, 0xC4EC])
    order = [int(i) for i in rng.permutation(len(done))]
    place = [placed[r.seed][1] for r in done]
    batch = max(place) + 1
    chosen = []
    for i in range(k):
        pick = next((j for j in order if place[j] == (i * batch) // k), order[0])
        order.remove(pick)
        chosen.append(pick)
    return [done[i] for i in sorted(chosen)]


def reference_models(domain, conf, specs, seed: int, device) -> dict:
    """The reference's modules with the run's weights, float32, drawn again
    from the seed exactly as the program's were."""
    with torch.device("meta"):
        models = domain.reference_models(conf)
    for name, module in models.items():
        drawn = weights.draw(specs[name], seed, name, device, torch.bfloat16)
        keys = module.state_dict().keys()
        module.load_state_dict({k: drawn[k].float() for k in keys}, strict=True, assign=True)
        del drawn
        module.eval()
    channels = conf["config"]["model"]["params"]["ddpmconfig"]["channels"]
    models["mixing_logit"] = weights.mixing_logit(seed, channels, conf["init"], device)
    return models


def readings(domain, conf, models, records, placed, nx, device):
    """(per-request pixel MAE of the served outputs against the reference
    computed with `nx`, the reference outputs)."""
    reqs = [Request(r.seed, *placed[r.seed]) for r in records]
    with torch.no_grad():
        ref = domain.reference(models, conf, reqs, nx, device)
    maes = [float(np.abs(r.result[0].astype(np.float32) - x.astype(np.float32)).mean() / 255.0)
            for r, x in zip(records, ref)]
    return maes, ref


def run(domain, conf, specs, seed: int, device, done, placed, nx, log=None) -> dict:
    chosen = choose(done, int(conf["check"]["requests"]), seed, placed)
    limit = conf["check"]["limits"]["pixel_mae"]
    if not chosen:  # nothing answered: the worst reading there is
        return {"pixel_mae": {"value": 1.0, "limit": limit}}
    models = reference_models(domain, conf, specs, seed, device)
    maes, ref = readings(domain, conf, models, chosen, placed, nx, device)
    if log is not None:
        log(f"check: {len(chosen)} requests, pixel MAE each {maes}; reference pixel std "
            f"{[round(float(x.astype(np.float32).std() / 255.0), 5) for x in ref]}")
    return {"pixel_mae": {"value": max(maes), "limit": limit}}
