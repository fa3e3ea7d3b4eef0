"""Weights made from the run's seed, on the device, in a few large calls.

A module's weights are one flat draw from a `torch.Generator` on the device,
seeded from the run's seed and the module's name, in the dtype they are
served in, scaled and shifted per tensor by two repeat-interleaved vectors,
then cut into the state dict's tensors (views of the flat buffer).  The
order of the tensors, their scales and their means come from the
benchmark (`specs`), so that the reference, built after the program is
freed, draws the very same values again."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# (key, shape, std, mean)
Spec = Tuple[str, Tuple[int, ...], float, float]

NORM_KEYS = ("norm", "in_layers.0", "out_layers.0", "out.0")


def default_spec(key: str, shape: Sequence[int], rules: Dict[str, dict]) -> Spec:
    """The scale of one tensor: a GroupNorm's weight about 1 and its bias
    about 0; a style modulation's bias about 1 (its init); the StyleGAN
    weights scaled at run time (5-d conv weights, modulations, 1x1 skips)
    unit normal; other weights of fan-in f normal with std gain / sqrt(f);
    biases and other vectors std 0.05.  `rules` maps a key substring to {"gain": g} (for
    weights of two or more dimensions) or {"std": s, "mean": m}; the last
    rule that matches wins."""
    shape = tuple(int(s) for s in shape)
    leaf = key.rsplit(".", 1)[-1]
    mean, std = 0.0, 0.05
    if len(shape) <= 1 and any(k in key for k in NORM_KEYS):
        mean, std = (1.0, 0.1) if leaf == "weight" else (0.0, 0.1)
    elif key.endswith("modulation.bias"):
        mean, std = 1.0, 0.1
    elif leaf == "bias":
        pass
    elif len(shape) == 5 or key.endswith("modulation.weight") or ".skip." in key:
        std = 1.0
    elif len(shape) >= 2:
        std = 1.0 / math.sqrt(math.prod(shape[1:]))
    for sub, rule in rules.items():
        if sub not in key:
            continue
        if "gain" in rule:
            if len(shape) >= 2:
                std = rule["gain"] / math.sqrt(math.prod(shape[1:]))
        else:
            std, mean = rule["std"], rule.get("mean", 0.0)
    return key, shape, std, mean


def specs_for(keys_shapes, rules: Dict[str, dict]) -> List[Spec]:
    return [default_spec(k, s, rules) for k, s in keys_shapes]


def module_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a module's name."""
    words = [int(seed) % 2**64 >> 32, int(seed) % 2**32] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def draw(specs: List[Spec], seed: int, name: str, device, dtype) -> Dict[str, torch.Tensor]:
    """The state dict of `specs` drawn for module `name`: key -> tensor."""
    counts = [math.prod(s) for _, s, _, _ in specs]
    g = torch.Generator(device=device).manual_seed(module_seed(seed, name))
    flat = torch.randn(sum(counts), generator=g, device=device, dtype=dtype)
    reps = torch.tensor(counts, device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor([s[2] for s in specs], dtype=dtype,
                                                   device=device), reps))
    flat.add_(torch.repeat_interleave(torch.tensor([s[3] for s in specs], dtype=dtype,
                                                   device=device), reps))
    out, ofs = {}, 0
    for (key, shape, _, _), n in zip(specs, counts):
        out[key] = flat[ofs : ofs + n].view(shape)
        ofs += n
    return out


def shapes_of(module: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every tensor of a module's state dict, in key order."""
    return sorted((k, tuple(v.shape)) for k, v in module.state_dict().items())


def model_specs(models: Dict[str, torch.nn.Module], extra: Dict[str, list],
                rules: Dict[str, dict]) -> Dict[str, List[Spec]]:
    """Per module: the reference's tensors in key order, then the tensors
    only the program loads (`extra`, key order), each with its scale."""
    out = {}
    for name, module in models.items():
        ref = shapes_of(module)
        have = {k for k, _ in ref}
        more = sorted((k, tuple(s)) for k, s in extra.get(name, []) if k not in have)
        out[name] = specs_for(ref + more, rules.get(name, {}))
    return out


def mixing_logit(seed: int, channels: int, init: dict, device) -> torch.Tensor:
    """The learned mixing logit (1, C, 1, 1), float32 as served: normal with
    the init's `mixing_logit_mean` and `mixing_logit_std`."""
    g = torch.Generator(device=device).manual_seed(module_seed(seed, "mixing_logit"))
    return (torch.randn((1, channels, 1, 1), generator=g, device=device)
            * init["mixing_logit_std"] + init["mixing_logit_mean"])


def state_dicts(specs: Dict[str, List[Spec]], seed: int, device, dtype, init: dict,
                channels: int) -> dict:
    """Every module's state dict, and the mixing logit."""
    out = {name: draw(s, seed, name, device, dtype) for name, s in specs.items()}
    out["mixing_logit"] = mixing_logit(seed, channels, init, device)
    return out
