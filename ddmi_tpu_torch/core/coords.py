"""Coordinate helpers of the sampling path (counterpart of
ddmi_tpu/core/coords.py)."""

from __future__ import annotations


def unsymmetrize(x):
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) / 2.0


def get_scale_injection(current_res: int, anchor_res: int = 256) -> float:
    return anchor_res / current_res
