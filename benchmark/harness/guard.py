"""What a run of the port may not load: JAX, its libraries and the JAX
package, compared by whole top-level module names (so `ddmi_tpu_torch`
passes where `ddmi_tpu` would not)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ddmi_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
