"""ddmi_tpu_torch.data: the port's loaders (numpy on the host; see
ddmi_tpu/data for the JAX counterparts, whose draws they repeat)."""

from ddmi_tpu_torch.data.binvox import BinvoxModel, read_voxels, write_voxels
from ddmi_tpu_torch.data.image_folder import ImageFolderDataset
from ddmi_tpu_torch.data.nerf import NeRFShapeNetDataset, SyntheticNeRF
from ddmi_tpu_torch.data.shapenet import ShapeNetOccupancyDataset, SyntheticOccupancy
from ddmi_tpu_torch.data.synthetic import SyntheticImages
from ddmi_tpu_torch.data.video import SyntheticVideos

__all__ = ["BinvoxModel", "ImageFolderDataset", "NeRFShapeNetDataset",
           "ShapeNetOccupancyDataset", "SyntheticImages", "SyntheticNeRF", "SyntheticOccupancy",
           "SyntheticVideos", "read_voxels", "write_voxels"]
