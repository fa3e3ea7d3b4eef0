"""Host-side utilities (counterpart of ddmi_tpu/utils, the
convocc/src/utils equivalents): mesh and point-cloud IO, ICP alignment,
matplotlib plots.  Everything here is numpy on the host: data preparation
and inspection tools, not compute-path code."""

from ddmi_tpu_torch.utils.icp import best_fit_transform, icp, nearest_neighbor
from ddmi_tpu_torch.utils.mesh_io import (
    export_pointcloud,
    load_pointcloud,
    read_off,
    write_off,
)
from ddmi_tpu_torch.utils.visualize import (
    visualize_data,
    visualize_pointcloud,
    visualize_voxels,
)

__all__ = [
    "best_fit_transform",
    "icp",
    "nearest_neighbor",
    "export_pointcloud",
    "load_pointcloud",
    "read_off",
    "write_off",
    "visualize_data",
    "visualize_pointcloud",
    "visualize_voxels",
]
