"""Voxel / pointcloud inspection plots (counterpart of
ddmi_tpu/utils/visualize.py, the convocc/src/utils/visualize.py
equivalent; matplotlib is optional and imported when a plot is made).
Axis conventions match the reference exactly (Z-X-Y order, elev=30 /
azim=45, visualize.py:25-85); matplotlib's deprecated
``fig.gca(projection=...)`` is replaced by ``add_subplot``.  The Agg
backend is forced so these work headless."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _ax3d():
    import matplotlib

    matplotlib.use("Agg", force=False)
    from matplotlib import pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    return plt, fig, ax


def visualize_data(data, data_type: Optional[str], out_file: str) -> None:
    """Dispatch on data type ('voxels' | 'pointcloud' | 'img' handled as in
    the reference; None/'idx' is a no-op)."""
    if data_type == "voxels":
        visualize_voxels(data, out_file=out_file)
    elif data_type == "pointcloud":
        visualize_pointcloud(data, out_file=out_file)
    elif data_type == "img":
        import matplotlib

        matplotlib.use("Agg", force=False)
        from matplotlib import pyplot as plt

        img = np.asarray(data)
        if img.ndim == 3 and img.shape[0] in (1, 3):  # CHW -> HWC
            img = np.moveaxis(img, 0, -1)
        plt.imsave(out_file, np.clip(img.squeeze(), 0.0, 1.0))
    elif data_type is None or data_type == "idx":
        pass
    else:
        raise ValueError(f'Invalid data_type "{data_type}"')


def visualize_voxels(voxels, out_file: Optional[str] = None,
                     show: bool = False) -> None:
    """Solid-voxel plot of a (d, h, w) boolean/float grid."""
    voxels = np.asarray(voxels).squeeze()
    plt, fig, ax = _ax3d()
    ax.voxels(voxels.transpose(2, 0, 1), edgecolor="k")
    ax.set_xlabel("Z")
    ax.set_ylabel("X")
    ax.set_zlabel("Y")
    ax.view_init(elev=30, azim=45)
    if out_file is not None:
        plt.savefig(out_file)
    if show:
        plt.show()
    plt.close(fig)


def visualize_pointcloud(points, normals=None,
                         out_file: Optional[str] = None,
                         show: bool = False) -> None:
    """Scatter an (n, 3) pointcloud (optionally with normal quivers) in the
    unit cube [-0.5, 0.5]^3."""
    points = np.asarray(points).reshape(-1, 3)
    plt, fig, ax = _ax3d()
    ax.scatter(points[:, 2], points[:, 0], points[:, 1])
    if normals is not None:
        normals = np.asarray(normals).reshape(-1, 3)
        ax.quiver(
            points[:, 2], points[:, 0], points[:, 1],
            normals[:, 2], normals[:, 0], normals[:, 1],
            length=0.1, color="k",
        )
    ax.set_xlabel("Z")
    ax.set_ylabel("X")
    ax.set_zlabel("Y")
    ax.set_xlim(-0.5, 0.5)
    ax.set_ylim(-0.5, 0.5)
    ax.set_zlim(-0.5, 0.5)
    ax.view_init(elev=30, azim=45)
    if out_file is not None:
        plt.savefig(out_file)
    if show:
        plt.show()
    plt.close(fig)
