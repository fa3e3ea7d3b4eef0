"""Checkpoints and resume (counterpart of ddmi_tpu/core/checkpoint.py, on
torch.save instead of Orbax; JAX checkpoints are not read: JAX weights
enter through interop.py).

`CheckpointManager(directory, max_to_keep=3, prefix)` keeps
`<directory>/<prefix>/<step>.pt` files, the newest `max_to_keep` of them.
A save writes a temporary file beside the target and renames it into
place, so a crash never leaves a torn file or loses the last complete
copy.  What is saved is a state's `state_dict()` (or a plain dict) of
tensors and Python scalars; `restore` loads the newest (or a given) step
and copies it into a state of the same layout, in place.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, prefix: str = "model"):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        self.max_to_keep = max_to_keep
        self.root = os.path.join(self.directory, prefix)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      (re.fullmatch(r"(\d+)\.pt", f) for f in os.listdir(self.root)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False, overwrite: bool = False) -> None:
        """Write `state` (its state_dict() when it has one) as step `step`.
        Every save is written (there is no save interval to force past);
        `force` is accepted for the JAX interface.  An existing checkpoint
        of this step is replaced only with `overwrite`, after the new one is
        complete."""
        del force
        path = self._path(step)
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(f"checkpoint {path} exists (pass overwrite=True)")
        obj = state.state_dict() if hasattr(state, "state_dict") else state
        tmp = path + ".tmp"
        torch.save(obj, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state_like: Any = None, step: Optional[int] = None,
                map_location: Any = "cpu") -> Any:
        """The saved object of `step` (the newest when None).  With a
        `state_like` that has load_state_dict, the object is copied into it
        and the state returned."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        obj = torch.load(self._path(step), map_location=map_location, weights_only=True)
        if state_like is not None and hasattr(state_like, "load_state_dict"):
            state_like.load_state_dict(obj)
            return state_like
        return obj
