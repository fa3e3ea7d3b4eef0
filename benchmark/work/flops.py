"""Model FLOPs counted by `torch.utils.flop_counter.FlopCounterMode` over
the plain reference on the meta device, so that no memory is taken and
nothing runs."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(fn) -> int:
    """The FLOPs of fn() (fn builds its own meta tensors)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
