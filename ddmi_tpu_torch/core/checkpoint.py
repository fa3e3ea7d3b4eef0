"""Checkpoints and resume (counterpart of ddmi_tpu/core/checkpoint.py, on
torch.save instead of Orbax; JAX checkpoints are not read: JAX weights
enter through interop.py).

`CheckpointManager(directory, max_to_keep=3, prefix)` keeps
`<directory>/<prefix>/<step>.pt` files, the newest `max_to_keep` of them.
A save writes a temporary file beside the target and renames it into
place, so a crash never leaves a torn file or loses the last complete
copy.  Under a process group every rank calls `save`: the state's split
tensors are gathered whole (parallel/mesh.py::gather_full) and rank 0
writes them, so a checkpoint restores at any world size.  What is saved is a state's `state_dict()` (or a plain dict) of
tensors and Python scalars; `restore` loads the newest (or a given) step
and copies it into a state of the same layout, in place.

The trainer saves `{"state": ..., "generators": [...]}` under the prefixes
`stage1` (state["params"]: `<module>.<name>` of the stage-1 modules) and
`stage2` (state["params"] and state["ema"]: `unet.<name>` and
`mixing_logit`).  `stage1_weights` and `stage2_weights` read the weights
alone out of the newest of them, on the CPU, for the trainer and the
sampling service.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ddmi_tpu_torch.parallel import distributed
from ddmi_tpu_torch.parallel.mesh import gather_full


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, prefix: str = "model"):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        self.max_to_keep = max_to_keep
        self.root = os.path.join(self.directory, prefix)

    def _path(self, step: int) -> str:
        return os.path.join(self.root, f"{int(step)}.pt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
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
        obj = state.state_dict() if hasattr(state, "state_dict") else state
        if distributed.initialized():
            # every rank gathers its shards; rank 0 writes the full state
            obj = gather_full(obj)
            if not distributed.is_main():
                distributed.barrier()
                return
        try:
            os.makedirs(self.root, exist_ok=True)
            if os.path.exists(path) and not overwrite:
                raise FileExistsError(f"checkpoint {path} exists (pass overwrite=True)")
            tmp = path + ".tmp"
            torch.save(obj, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        finally:
            distributed.barrier()

    def restore(self, state_like: Any = None, step: Optional[int] = None,
                map_location: Any = "cpu", mmap: bool = False) -> Any:
        """The saved object of `step` (the newest when None).  With a
        `state_like` that has load_state_dict, the object is copied into it
        and the state returned.  `mmap` maps the file instead of reading
        it: a tensor's bytes are read when it is used."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        obj = torch.load(self._path(step), map_location=map_location, weights_only=True,
                         mmap=mmap)
        if state_like is not None and hasattr(state_like, "load_state_dict"):
            state_like.load_state_dict(obj)
            return state_like
        return obj


def stage1_weights(directory: str, modules) -> Tuple[int, Dict[str, dict]]:
    """The state_dicts of the stage-1 `modules` (e.g. ("vae", "mlp")) in
    the newest `<directory>/stage1` checkpoint, on the CPU; -> (its step,
    {module: state_dict}).  FileNotFoundError when there is none.  The
    file is mapped, so only the weights are read, not the optimizer's
    moments."""
    ckpt = CheckpointManager(directory, prefix="stage1")
    step = ckpt.latest_step()
    params = ckpt.restore(step=step, mmap=True)["state"]["params"]
    return step, {name: {k[len(name) + 1:]: v for k, v in params.items()
                         if k.startswith(name + ".")} for name in modules}


def stage2_weights(directory: str, use_ema: bool = True) -> Tuple[int, Dict[str, Any]]:
    """The UNet's state_dict and the mixing logit of the newest
    `<directory>/stage2` checkpoint, its EMA copy unless `use_ema` is off,
    on the CPU; -> (the state's step, {"unet": state_dict, "mixing_logit":
    tensor}).  FileNotFoundError when there is none.  The file is mapped,
    so of celebahq's 18 GB train state only the served copy is read."""
    state = CheckpointManager(directory, prefix="stage2").restore(mmap=True)["state"]
    weights = state["ema"] if use_ema else state["params"]
    unet = {k[len("unet."):]: v for k, v in weights.items() if k.startswith("unet.")}
    return int(state["step"]), {"unet": unet, "mixing_logit": weights["mixing_logit"]}
