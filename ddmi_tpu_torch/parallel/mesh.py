"""The device mesh, the batch split and the placement of the train state
(counterpart of ddmi_tpu/parallel/mesh.py and of the JAX trainer's
`_put_batch`, `_state_shardings` and `_sample_jit`).

The JAX package lays its devices out as a ('data', 'fsdp', 'model') mesh:
the batch is split over 'data', every params-sized leaf of the state
(parameters, EMA, Adam moments, MultiSteps accumulators) is split over
'fsdp' along its largest divisible axis, and 'model' would split the last
axis for tensor parallelism.  The port keeps the arithmetic and the names:

- `make_mesh(spec, world_size)` resolves the sizes as JAX's `make_mesh`
  does (with the same loud fallback to data = n) and returns a
  `torch.distributed.device_mesh.DeviceMesh` with dims ('data', 'fsdp',
  'model'), or the resolved MeshSpec when no process group exists.
- `shard_batch` gives a rank its rows of the global batch, padded by
  wrap-around to a multiple of the data size as JAX's `_put_batch` pads.
- `fsdp_spec_for` and `shard_params_tp_fsdp` are JAX's placement rules as
  shape functions on JAX's axis order.  `port_fsdp_dim` applies the fsdp
  rule to a port tensor: a convolution (O, I, *k) or a linear layer (O, I)
  is read in JAX's (*k, I, O) / (I, O) order, so that where two axes tie
  the port splits the same logical axis as JAX.
- `shard_module` applies the rule through FSDP2: `fully_shard` over the 2-D
  ('data', 'fsdp') mesh (HSDP: replicated over 'data', split over 'fsdp';
  with fsdp 1 plain replication, as JAX's `_state_shardings` replicates),
  with a `shard_placement_fn` that picks the rule's dim.  Leaves that JAX
  keeps whole (no axis divides) are left out of FSDP2 and stay whole on
  every rank; `reduce_grads` averages their gradients over the ranks.  An
  optimizer, EMA or accumulator built with `zeros_like` / `clone` of the
  sharded parameters is sharded as they are, as JAX's `shard_state` shards
  it.
- 'model' > 1 is refused by the trainer (the port's kernels take whole
  tensors); `shard_params_tp_fsdp` is here so that the rule itself is held
  against JAX's.

Checkpoints hold full tensors: `gather_full` collects a state on every
rank, `copy_full_` copies a full tensor into a (possibly sharded) one.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ddmi_tpu_torch.parallel import distributed

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1
    fsdp: int = 1
    model: int = 1


def resolve(spec: Optional[MeshSpec], n: int) -> MeshSpec:
    """The mesh sizes JAX's make_mesh resolves for `spec` on n devices: a
    data size of -1 takes what fsdp x model leave; a product other than n
    falls back to data = n, fsdp = model = 1, with JAX's warning."""
    spec = spec or MeshSpec()
    data = spec.data if spec.data > 0 else max(1, n // (spec.fsdp * spec.model))
    if data * spec.fsdp * spec.model != n:
        warnings.warn(
            f"requested mesh data={data} fsdp={spec.fsdp} model={spec.model} "
            f"needs {data * spec.fsdp * spec.model} devices, have {n}; "
            f"falling back to data={n}, fsdp=1, model=1 (NO parameter "
            f"sharding — a config that documents fsdp as required for "
            f"training memory will OOM on this fallback)", stacklevel=2)
        return MeshSpec(data=n)
    return MeshSpec(data, spec.fsdp, spec.model)


def make_mesh(spec: Optional[MeshSpec] = None, world_size: Optional[int] = None,
              device_type: Optional[str] = None):
    """The ('data', 'fsdp', 'model') DeviceMesh over the process group's
    ranks (world_size, default the group's), or the resolved MeshSpec when
    there is no process group."""
    n = world_size or distributed.world_size()
    sizes = resolve(spec, n)
    if not distributed.initialized():
        return sizes
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (sizes.data, sizes.fsdp, sizes.model),
                            mesh_dim_names=AXES)


def data_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's index on 'data', the data size)."""
    if isinstance(mesh, MeshSpec):
        return 0, mesh.data
    return mesh.get_local_rank(DATA_AXIS), mesh.size(0)


def data_group(mesh):
    """The process group of this rank's 'data' dim (None without a mesh)."""
    return None if isinstance(mesh, MeshSpec) else mesh.get_group(DATA_AXIS)


# ------------------------------------------------------------------ batches


def padded_size(b: int, d: int) -> int:
    """The batch size after JAX's wrap-around pad to a multiple of d."""
    return b + (-b) % d


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    if batch is None or isinstance(batch, (int, float, str)):
        return batch
    return fn(batch)


def shard_batch(batch, index: int, size: int, warn: bool = True):
    """Rows index * m .. (index + 1) * m of a global batch (an array or
    tensor, or a dict / tuple / list of them, batch-major), m = the padded
    batch / size.  A batch that `size` does not divide is first padded by
    wrap-around repetition, as the JAX trainer's `_put_batch` pads (the
    repeated samples re-weight that step's mean loss slightly)."""

    def rows(x):
        b = x.shape[0]
        n = padded_size(b, size)
        if n != b:
            if warn:
                warnings.warn(f"batch {b} not divisible by data axis {size}; padding by "
                              f"wrap-around to {n}", stacklevel=4)
            reps = -(-n // b)
            if isinstance(x, torch.Tensor):
                x = torch.cat([x] * reps, 0)[:n]
            else:
                x = np.concatenate([np.asarray(x)] * reps, 0)[:n]
        m = n // size
        return x[index * m:(index + 1) * m]

    return _map(rows, batch)


class RowDraws:
    """Standard-normal draws for the global batch from a shared generator,
    of which this rank keeps its rows: `draw(shape)` draws (shape[0] *
    size, *shape[1:]) fp32 and returns rows index * shape[0] ..  A module
    that draws as it runs (nn/stylegan.py::NoiseInjection) takes it in
    place of its generator, so that each rank's rows are the world-1
    run's."""

    def __init__(self, generator: torch.Generator, index: int, size: int):
        self.generator, self.index, self.size = generator, index, size

    def draw(self, shape) -> torch.Tensor:
        b = shape[0]
        full = torch.randn((b * self.size,) + tuple(shape[1:]), generator=self.generator,
                           device=self.generator.device, dtype=torch.float32)
        return full[self.index * b:(self.index + 1) * b]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rows of every rank of `group`, concatenated in rank order (x
    itself without a process group)."""
    if not distributed.initialized():
        return x
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 0)


# -------------------------------------------------------------- placement


def fsdp_spec_for(shape: Sequence[int], fsdp_size: int) -> Optional[int]:
    """JAX's `_fsdp_spec_for` on a shape in JAX's axis order: the largest
    axis that fsdp_size divides (the first of equal ones), or None (whole)."""
    if fsdp_size <= 1 or len(shape) == 0:
        return None
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
            return i
    return None


def shard_params_tp_fsdp(shape: Sequence[int], fsdp_size: int,
                         tp_size: int) -> Tuple[Optional[str], ...]:
    """JAX's `shard_params_tp_fsdp` rule for one leaf (JAX order): the last
    axis over 'model' when tp_size divides it, and the largest remaining
    axis that fsdp_size divides over 'fsdp'.  -> the mesh axis of each
    array axis (None: not split)."""
    if len(shape) == 0:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    if tp_size > 1 and shape[-1] % tp_size == 0 and shape[-1] >= tp_size:
        spec[-1] = MODEL_AXIS
    if fsdp_size > 1 and len(shape) > 1:
        rest = list(shape[:-1])
        for i in sorted(range(len(rest)), key=lambda i: -rest[i]):
            if rest[i] % fsdp_size == 0 and rest[i] >= fsdp_size:
                spec[i] = FSDP_AXIS
                break
    return tuple(spec)


def shard_state(shape: Sequence[int], mesh: MeshSpec) -> Tuple[Optional[str], ...]:
    """JAX's `shard_state` rule for one leaf (JAX order): with model > 1
    `shard_params_tp_fsdp`, else the fsdp axis alone."""
    if mesh.model > 1:
        return shard_params_tp_fsdp(shape, mesh.fsdp, mesh.model)
    spec: List[Optional[str]] = [None] * len(shape)
    axis = fsdp_spec_for(shape, mesh.fsdp)
    if axis is not None:
        spec[axis] = FSDP_AXIS
    return tuple(spec)


def jax_axes(ndim: int) -> List[int]:
    """The port dim of each JAX axis of a weight: a convolution (O, I, *k)
    is (*k, I, O) in JAX, a linear layer (O, I) is (I, O); vectors and
    scalars keep their order."""
    if ndim < 2:
        return list(range(ndim))
    return list(range(2, ndim)) + [1, 0]


def port_fsdp_dim(shape: Sequence[int], fsdp_size: int) -> Optional[int]:
    """The port dim JAX's fsdp rule splits for a port tensor of `shape`
    (read in JAX's axis order, see jax_axes), or None (whole)."""
    axes = jax_axes(len(shape))
    axis = fsdp_spec_for([shape[d] for d in axes], fsdp_size)
    return None if axis is None else axes[axis]


# ------------------------------------------------------------------- FSDP2


def is_fsdp(module) -> bool:
    """True for a module `shard_module` has wrapped."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _swap_cast(module: torch.nn.Module, names: List[str]) -> None:
    """Forward hooks on `module` that run its whole forward on bf16 casts of
    its fp32 parameters `names` (dotted names; FSDP2's mixed precision casts
    only the parameters it shards); autograd carries the gradients back
    through the casts.  The hooks sit on `module` itself, not on the
    parameters' owners: a forward may read a submodule's parameters without
    calling it (the UNet's last convolution)."""
    owners = [(module.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2])
              for n in names]
    masters: List[torch.Tensor] = []

    def pre(mod, args):
        masters[:] = [owner._parameters[attr] for owner, attr in owners]
        for (owner, attr), p in zip(owners, masters):
            owner._parameters[attr] = p.to(torch.bfloat16)

    def post(mod, args, out):
        for (owner, attr), p in zip(owners, masters):
            owner._parameters[attr] = p
        masters.clear()

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


def shard_module(module: torch.nn.Module, mesh, amp: bool = False) -> List[str]:
    """FSDP2 over `mesh`'s ('data', 'fsdp') dims, in place: every parameter
    split along `port_fsdp_dim` over 'fsdp' and replicated over 'data'.
    With fsdp > 1, parameters no axis of which fsdp divides stay whole on
    every rank, out of FSDP2 (their gradients need `reduce_grads`).  With `amp` the
    forward computes on bf16 casts of the fp32 parameters (FSDP2's
    MixedPrecisionPolicy, gradients reduced in fp32; the whole ones through
    forward hooks on `module`), the JAX package's amp policy; inputs are not cast.  The
    module must be called through its forward.  -> the names of the whole
    parameters."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard
    from torch.distributed.tensor import Shard

    # FSDP2 splits contiguous parameters only (the card's channels-last
    # layout is not); its unsharded parameters are contiguous anyway
    module.to(memory_format=torch.contiguous_format)
    fsdp = mesh.size(1)
    # with fsdp 1 every parameter is whole on a one-rank shard dim: FSDP2's
    # replication over 'data'
    whole = {n for n, p in module.named_parameters()
             if fsdp > 1 and port_fsdp_dim(p.shape, fsdp) is None}
    ignored = {p for n, p in module.named_parameters() if n in whole}
    if amp and whole:
        _swap_cast(module, sorted(n for n, p in module.named_parameters()
                                  if n in whole and p.dtype == torch.float32))
    mp = (MixedPrecisionPolicy(param_dtype=torch.bfloat16, reduce_dtype=torch.float32,
                               cast_forward_inputs=False) if amp else MixedPrecisionPolicy())
    kwargs = {"ignored_params": ignored} if ignored else {}
    fully_shard(module, mesh=mesh[(DATA_AXIS, FSDP_AXIS)],
                shard_placement_fn=lambda p: Shard(port_fsdp_dim(p.shape, fsdp) or 0),
                mp_policy=mp, **kwargs)
    return sorted(whole)


@torch.no_grad()
def reduce_grads(params: Iterable[torch.Tensor], group=None) -> None:
    """Average the gradients of plain (unsharded) parameters over the
    ranks of `group`, in one flat all-reduce per dtype (DDP's arithmetic:
    the sum, then / the group's size)."""
    if not distributed.initialized() or dist.get_world_size(group) == 1:
        return
    grads = [p.grad for p in params if p.grad is not None and not is_sharded(p.grad)]
    n = dist.get_world_size(group)
    if not grads:
        return
    for dtype in sorted({g.dtype for g in grads}, key=str):
        part = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in part])
        dist.all_reduce(flat, group=group)
        flat /= n
        for g, v in zip(part, flat.split([g.numel() for g in part])):
            g.copy_(v.view_as(g))


def local(tensors):
    """The rank's local tensors of sharded ones (plain tensors as they are):
    elementwise updates of tensors split alike run on them, without the
    DTensor dispatch each op of a DTensor takes; in place, they update the
    DTensors."""
    return [t.to_local() if is_sharded(t) else t for t in tensors]


def gather_full(obj):
    """`obj` (a state dict of tensors, lists and scalars) with every
    sharded tensor gathered whole, on every rank (a collective: every rank
    calls it); plain tensors are returned as they are."""
    if isinstance(obj, dict):
        return {k: gather_full(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(gather_full(v) for v in obj)
    if is_sharded(obj):
        return obj.full_tensor().detach()
    return obj


@torch.no_grad()
def copy_full_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the full tensor `src` into `dst`, whose local part is taken
    when it is sharded (no communication: every rank holds `src`)."""
    if is_sharded(dst):
        from torch.distributed.tensor import distribute_tensor

        src = distribute_tensor(src.to(device=dst.device, dtype=dst.dtype), dst.device_mesh,
                                dst.placements, src_data_rank=None)
    dst.copy_(src)

