"""Quality-parity gates (the port's own copy of ddmi_tpu/evals/gates.py):
compare eval metrics to published reference numbers.

The gate values are the user's, transcribed from the DDMI paper
(arXiv:2401.12517) into the config; the repository ships none.  One
`mode: eval` run then returns a pass/fail verdict.

Config shape (data.extra.quality_gates):

    quality_gates:
      fid: {published: 7.25, tol_pct: 2.0}          # lower is better
      cov: {published: 0.55, tol_pct: 2.0, direction: max}   # higher better

A metric passes when it is within tol_pct of the published value in the
favorable direction: `value <= published * (1 + tol)` for `min` metrics,
`value >= published * (1 - tol)` for `max` metrics.  Beating the published
number outright always passes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

# lower-is-better unless listed here (coverage / precision-recall style)
_MAX_METRICS = {"cov", "coverage", "psnr", "iou", "iou_voxels", "fscore"}


def check_gates(results: Mapping[str, float],
                gates: Mapping[str, Any]) -> Tuple[bool, Dict[str, Dict[str, Any]]]:
    """-> (all passed, per-metric detail).  A gate whose published value is
    missing or None (the shipped configs hold placeholders until a user
    fills them from the paper) or whose `direction` is not 'min' / 'max' (a
    typo would silently invert the verdict) raises ValueError.  A gated
    metric absent from the results (e.g. occupancy MMD/COV skipped because
    no mesh was generated) is a failing gate, not an exception, so that
    the caller can still write its verdict."""
    detail: Dict[str, Dict[str, Any]] = {}
    ok = True
    for name, spec in gates.items():
        if not isinstance(spec, Mapping):
            spec = {"published": spec}
        published = spec.get("published")
        if published is None:
            raise ValueError(
                f"quality gate '{name}' has no published value — transcribe "
                "it from the DDMI paper (arXiv:2401.12517) into the config; "
                "this build environment cannot fetch it (zero egress)")
        tol = float(spec.get("tol_pct", 2.0)) / 100.0
        direction = spec.get("direction", "max" if name in _MAX_METRICS else "min")
        if direction not in ("min", "max"):
            raise ValueError(f"quality gate '{name}': direction must be 'min' or 'max', "
                             f"got {direction!r}")
        if name not in results:
            detail[name] = {
                "value": None, "published": float(published), "tol_pct": tol * 100.0,
                "direction": direction, "bound": None, "passed": False,
                "reason": (f"metric absent from eval results {sorted(results)} — the eval "
                           "skipped it (e.g. no generated meshes) or the domain config is "
                           "wrong"),
            }
            ok = False
            continue
        value = float(results[name])
        published = float(published)
        if direction == "max":
            bound = published * (1.0 - tol)
            passed = value >= bound
        else:
            bound = published * (1.0 + tol)
            passed = value <= bound
        detail[name] = {"value": value, "published": published, "tol_pct": tol * 100.0,
                        "direction": direction, "bound": bound, "passed": passed}
        ok = ok and passed
    return ok, detail
