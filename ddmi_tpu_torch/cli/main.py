"""The port's command line (counterpart of ddmi_tpu/cli/main.py):

    python -m ddmi_tpu_torch.cli.main --exp {d2c-vae,ldm} --configs <yaml> \
        [--seed 42] [--device cuda]

The YAML schema is the JAX package's; `data.mode` picks train, gen or eval.
`--exp d2c-vae` is stage 1, `--exp ldm` stage 2 (its training takes the
stage-1 modules of the newest stage-1 checkpoint in data.save_pth); gen and
eval read the newest checkpoints there (core/trainer.py).  The run takes
the card unless `--device cpu` is given, and without a card it raises
rather than fall back to the CPU.  Under torchrun
(`torchrun --nproc_per_node=N -m ddmi_tpu_torch.cli.main ...`) each rank
starts the process group (parallel/distributed.py: NCCL on the cards,
gloo with --device cpu), takes card LOCAL_RANK, and trains or samples on
its rows of cfg.mesh (core/trainer.py).
"""

from __future__ import annotations

import argparse

from ddmi_tpu_torch.core.config import load_config


def build_dataset(cfg, train: bool = True, num_processes: int = 1, process_index: int = 0):
    """The training (or test) loader of the config: `data.dataset:
    synthetic` draws seeded batches at the real shapes; otherwise image
    folders, frame folders (sky / skytimelapse / folder), ShapeNet
    occupancy or srn-cars objects under data.data_dir (data.test_data_dir).
    Stage-1 multiscale image training reads images at twice the anchor
    resolution, everything else at the anchor.  The image folders take
    every num_processes-th file from process_index on, as the JAX CLI
    shards them over its processes, and give each of the num_processes
    data ranks its rows of the global batch: batch_size / num_processes,
    rounded up (JAX pads the global batch by wrap-around to a multiple of
    the data size; here the extra rows are further files).  So the global
    batch, and the steps of an epoch, are the one-process run's.  The other
    loaders are not sharded: each rank keeps its rows of their global
    batch (core/trainer.py)."""
    from ddmi_tpu_torch.data import ImageFolderDataset, SyntheticImages

    d = cfg.data
    root = d.data_dir if train else d.test_data_dir
    anchor = cfg.model.ddconfig.resolution
    train_res = 2 * anchor if cfg.model.lossconfig.multiscale else anchor
    bs = d.batch_size if train else d.test_batch_size
    if d.dataset == "synthetic":
        if d.domain == "video":
            from ddmi_tpu_torch.data.video import SyntheticVideos

            return SyntheticVideos(bs, frames=d.frames, resolution=anchor)
        if d.domain == "occupancy":
            from ddmi_tpu_torch.data.shapenet import SyntheticOccupancy

            return SyntheticOccupancy(bs)
        if d.domain == "nerf":
            from ddmi_tpu_torch.data.nerf import SyntheticNeRF

            return SyntheticNeRF(bs, resolution=d.test_resolution)
        return SyntheticImages(bs, resolution=train_res if train else anchor)
    if d.domain == "image":
        return ImageFolderDataset(root, -(-bs // num_processes),
                                  resolution=train_res if train else anchor,
                                  random_flip=train, num_processes=num_processes,
                                  process_index=process_index, workers=d.num_workers)
    if d.domain == "video":
        from ddmi_tpu_torch.data.video import make_video_dataset

        return make_video_dataset(d.dataset if d.dataset != "folder" else "sky", root, bs,
                                  frames=d.frames, resolution=anchor, workers=d.num_workers)
    if d.domain == "occupancy":
        from ddmi_tpu_torch.data.shapenet import ShapeNetOccupancyDataset

        # the sampling settings of the nested convocc config, when there is one
        ds_kw = {}
        if d.conv_config:
            from ddmi_tpu_torch.core.convocc_config import load_convocc_config

            cc = load_convocc_config(d.conv_config).get("data") or {}
            ds_kw = {"points_subsample": cc.get("points_subsample", 2048),
                     "pointcloud_n": cc.get("pointcloud_n", 3000),
                     "pointcloud_noise": cc.get("pointcloud_noise", 0.005),
                     "categories": cc.get("classes")}
            # binvox grids for the iou_voxels protocol, on the test split
            if not train and cc.get("voxels_file"):
                ds_kw["voxels_file"] = cc["voxels_file"]
        return ShapeNetOccupancyDataset(root, d.batch_size, split="train" if train else "test",
                                        **ds_kw)
    if d.domain == "nerf":
        from ddmi_tpu_torch.data.nerf import NeRFShapeNetDataset

        return NeRFShapeNetDataset(root, d.batch_size, train=train)
    raise NotImplementedError(d.domain)


def pipeline_class(domain: str):
    """The pipeline class of a domain."""
    if domain == "image":
        from ddmi_tpu_torch.domains.image import ImagePipeline as Pipeline
    elif domain == "video":
        from ddmi_tpu_torch.domains.video import VideoPipeline as Pipeline
    elif domain == "occupancy":
        from ddmi_tpu_torch.domains.occupancy import OccupancyPipeline as Pipeline
    elif domain == "nerf":
        from ddmi_tpu_torch.domains.nerf import NeRFPipeline as Pipeline
    else:
        raise NotImplementedError(domain)
    return Pipeline


def build_pipeline(cfg, device="cuda"):
    """The domain's pipeline on `device`, its weights drawn from cfg.seed;
    stage-1 image and video training gets LPIPS
    (evals/lpips.py::build_perceptual), which the other modes never call."""
    domain = cfg.data.domain
    Pipeline = pipeline_class(domain)
    if cfg.exp == "d2c-vae" and domain in ("image", "video") and cfg.data.mode == "train":
        from ddmi_tpu_torch.evals.lpips import build_perceptual

        return Pipeline(cfg, device=device, seed=cfg.seed,
                        perceptual=build_perceptual(cfg, device))
    return Pipeline(cfg, device=device, seed=cfg.seed)


def main(argv=None):
    p = argparse.ArgumentParser("ddmi_tpu_torch")
    p.add_argument("--exp", choices=["d2c-vae", "ldm"], required=True)
    p.add_argument("--configs", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

    from ddmi_tpu_torch.core.device import resolve_device
    from ddmi_tpu_torch.core.trainer import Trainer
    from ddmi_tpu_torch.parallel import distributed
    from ddmi_tpu_torch.parallel.mesh import MeshSpec, data_coordinate, make_mesh

    # the process group first (a no-op without torchrun's environment)
    distributed.maybe_initialize(args.device)
    device = resolve_device(distributed.local_device(args.device))
    cfg = load_config(args.configs, exp=args.exp, seed=args.seed)
    m = cfg.mesh
    mesh = None
    if m.model <= 1:  # Trainer refuses model > 1, saying why
        mesh = make_mesh(MeshSpec(m.data, m.fsdp, m.model), device_type=device.type)
    shard = dict(zip(("process_index", "num_processes"),
                     data_coordinate(mesh) if mesh is not None else (0, 1)))
    pipe = build_pipeline(cfg, device)
    mode = cfg.data.mode
    if mode == "gen":
        Trainer(cfg, pipe, build_dataset(cfg, train=False), mesh=mesh).generate()
        return
    if mode == "eval":
        Trainer(cfg, pipe, build_dataset(cfg, train=False), mesh=mesh).evaluate(args.exp)
        return
    train_data = build_dataset(cfg, train=True, **shard)
    try:
        test_data = build_dataset(cfg, train=False)
    except (FileNotFoundError, NotImplementedError):
        test_data = None
    trainer = Trainer(cfg, pipe, train_data, test_data, mesh=mesh)
    if args.exp == "d2c-vae":
        trainer.train_stage1(resume=cfg.model.resume)
    else:
        trainer.train_stage2(resume=cfg.model.resume)


if __name__ == "__main__":
    main()
