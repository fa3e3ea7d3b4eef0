"""DiffAugment for the discriminator's inputs (counterpart of
ddmi_tpu/losses/diffaugment.py): colour, translation and cutout on NHWC
images, each step driven by explicit draws, so that the target and the
output of one micro-step get the same augmentation and a caller may feed
another framework's draws.  `draw_diffaugment` makes the draws from a
generator; `diff_augment` applies them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

# per step: (name, draw kinds): "u" a (b,) uniform, "t" a (b,) shift pair,
# "c" a (b,) centre pair
_POLICIES = {
    "color": ("brightness", "saturation", "contrast"),
    "translation": ("translation",),
    "cutout": ("cutout",),
}
TRANSLATION_RATIO, CUTOUT_RATIO = 0.125, 0.5


def _steps(policy: Sequence[str]) -> List[str]:
    return [fn for p in policy for fn in _POLICIES[p]]


def draw_diffaugment(shape, policy: Sequence[str], generator: Optional[torch.Generator] = None,
                     device=None) -> list:
    """The draws for NHWC images of `shape`, step by step: brightness,
    saturation and contrast a (b,) uniform each; translation (tx, ty) in
    [-round(h / 8), round(h / 8)] and [-round(w / 8), round(w / 8)];
    cutout centres (cy, cx) in [0, h + 1 - (ch % 2)) and [0, w + 1 - (cw %
    2)) for a cutout of round(h / 2) x round(w / 2)."""
    b, h, w, _ = shape
    out = []
    for fn in _steps(policy):
        if fn in ("brightness", "saturation", "contrast"):
            out.append(torch.rand((b,), generator=generator, device=device))
        elif fn == "translation":
            sh, sw = int(h * TRANSLATION_RATIO + 0.5), int(w * TRANSLATION_RATIO + 0.5)
            out.append((torch.randint(-sh, sh + 1, (b,), generator=generator, device=device),
                        torch.randint(-sw, sw + 1, (b,), generator=generator, device=device)))
        else:
            ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
            out.append((torch.randint(0, h + (1 - ch % 2), (b,), generator=generator,
                                      device=device),
                        torch.randint(0, w + (1 - cw % 2), (b,), generator=generator,
                                      device=device)))
    return out


def rand_brightness(x, u):
    return x + (u.reshape(-1, 1, 1, 1) - 0.5)


def rand_saturation(x, u):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (u.reshape(-1, 1, 1, 1) * 2) + mean


def rand_contrast(x, u):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (u.reshape(-1, 1, 1, 1) + 0.5) + mean


def rand_translation(x, shifts):
    """Shift each image by (tx, ty) pixels along (H, W), zero-filled."""
    b, h, w, _ = x.shape
    sh, sw = int(h * TRANSLATION_RATIO + 0.5), int(w * TRANSLATION_RATIO + 0.5)
    tx, ty = shifts
    pad = F.pad(x, (0, 0, sw, sw, sh, sh))
    rows = (torch.arange(h, device=x.device)[None] + sh + tx[:, None])[:, :, None]
    cols = (torch.arange(w, device=x.device)[None] + sw + ty[:, None])[:, None, :]
    return pad[torch.arange(b, device=x.device)[:, None, None], rows, cols]


def rand_cutout(x, centres):
    """Zero a round(h / 2) x round(w / 2) box around each image's centre."""
    b, h, w, _ = x.shape
    ch, cw = int(h * CUTOUT_RATIO + 0.5), int(w * CUTOUT_RATIO + 0.5)
    cy, cx = (c.reshape(b, 1, 1) for c in centres)
    ys = torch.arange(h, device=x.device).reshape(1, h, 1)
    xs = torch.arange(w, device=x.device).reshape(1, 1, w)
    mask = ((ys - cy).abs() >= ch // 2) | ((xs - cx).abs() >= cw // 2)
    return x * mask.to(x.dtype)[..., None]


_FNS = {"brightness": rand_brightness, "saturation": rand_saturation,
        "contrast": rand_contrast, "translation": rand_translation, "cutout": rand_cutout}


def diff_augment(x: torch.Tensor, policy: Sequence[str], draws: list) -> torch.Tensor:
    """Apply the policy's steps to NHWC images with `draws` from
    `draw_diffaugment`."""
    for fn, d in zip(_steps(policy), draws):
        x = _FNS[fn](x, d)
    return x
