"""Distribution of the port over processes and cards (counterpart of
ddmi_tpu/parallel): torchrun's process group (distributed.py) and the
('data', 'fsdp', 'model') mesh with its batch split and state placement
(mesh.py)."""

from ddmi_tpu_torch.parallel.distributed import maybe_initialize
from ddmi_tpu_torch.parallel.mesh import MeshSpec, make_mesh, shard_batch, shard_module

__all__ = ["MeshSpec", "make_mesh", "maybe_initialize", "shard_batch", "shard_module"]
