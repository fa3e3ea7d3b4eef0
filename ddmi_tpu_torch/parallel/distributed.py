"""Multi-process boot (counterpart of ddmi_tpu/parallel/distributed.py).

The JAX package starts its coordination service from JAX_COORDINATOR_ADDRESS
or a TPU pod's environment.  The port runs one process per card under
torchrun, which exports RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT; `maybe_initialize()` reads them and starts the process group:
NCCL on the card, gloo on the CPU.  On the card each process takes card
LOCAL_RANK.  Without those variables it does nothing, so a plain
`python -m ddmi_tpu_torch.cli.main ...` runs as one process, as before.

Launch line, N cards of one host:

    torchrun --nproc_per_node=N -m ddmi_tpu_torch.cli.main --exp ldm \\
        --configs configs/ldm/celebahq.yaml
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def env_present() -> bool:
    """True when torchrun's variables are all set."""
    return all(k in os.environ for k in _ENV)


def maybe_initialize(device="cuda") -> bool:
    """Start the process group from torchrun's environment: NCCL when
    `device` is a CUDA device (after torch.cuda.set_device(LOCAL_RANK)),
    gloo on the CPU.  Returns True when a group exists (now or from an
    earlier call), False when the environment asks for none.  A LOCAL_RANK
    without a card of that index raises: a rank never falls back to the
    CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not env_present():
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = int(os.environ["LOCAL_RANK"])
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local} but {count} CUDA device(s) are visible: each rank needs "
                f"a card of its own (pass --device cpu to run the ranks on the CPU)")
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if cuda else "gloo",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def local_device(device="cuda") -> torch.device:
    """The device of this rank: cuda:LOCAL_RANK under torchrun on the card,
    else `device` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    """Rank 0, or the only process: the one that logs and writes files."""
    return not initialized() or dist.get_rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()
