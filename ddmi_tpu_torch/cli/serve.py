"""Serve a trained DDMI model over HTTP with request micro-batching
(counterpart of ddmi_tpu/cli/serve.py).

Usage:
  python -m ddmi_tpu_torch.cli.serve --configs configs/ldm/celebahq.yaml \
      [--port 8500] [--batch 8] [--resolution 256] [--no-warmup] \
      [--turbo K] [--device cuda]

Restores the stage-1 and stage-2 checkpoints from the config's
`data.save_pth` (written by the port's trainer, `ddmi_tpu_torch.cli.main`,
or converted from the original repository's files by
`ddmi_tpu_torch.cli.convert_reference_ckpt`), runs one warm-up batch and
coalesces concurrent requests into device batches.  See
ddmi_tpu_torch/serve/server.py for the API.  It runs on the card unless
`--device cpu` is given, and without a card it raises.
"""

from __future__ import annotations

import argparse

from ddmi_tpu_torch.core.config import load_config


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--batch", type=int, default=8,
                    help="service batch (requests are coalesced into it)")
    ap.add_argument("--resolution", type=int, default=None,
                    help="render resolution (default: data.test_resolution)")
    ap.add_argument("--linger-ms", type=float, default=20.0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--no-ema", action="store_true",
                    help="serve raw params instead of the EMA copy")
    ap.add_argument("--n-views", type=int, default=8,
                    help="nerf: camera-path views per scene")
    ap.add_argument("--mesh-resolution0", type=int, default=None,
                    help="occupancy: MISE base grid resolution")
    ap.add_argument("--mesh-upsampling", type=int, default=None,
                    help="occupancy: MISE octree refinement steps")
    ap.add_argument("--turbo", type=int, default=1, metavar="K",
                    help="encoder-propagation sampling: run the UNet's down path "
                    "only every K-th DDIM step (arXiv:2312.09608).  K>1 trades "
                    "sample exactness for throughput; default 1 = exact sampling")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def build_service(args):
    """The SamplerService the arguments describe, restored from the
    config's save_pth; --turbo K > 1 sets ddpmconfig.extra["encoder_reuse"]
    (refused with ValueError for the MDTv2 denoiser)."""
    from ddmi_tpu_torch.core.device import resolve_device
    from ddmi_tpu_torch.serve.server import SamplerService

    mesh_kwargs = {}
    if args.mesh_resolution0 is not None:
        mesh_kwargs["resolution0"] = args.mesh_resolution0
    if args.mesh_upsampling is not None:
        mesh_kwargs["upsampling_steps"] = args.mesh_upsampling
    device = resolve_device(args.device)
    cfg = load_config(args.configs)
    if args.turbo > 1:
        if cfg.model.DiT:
            raise ValueError("--turbo needs the UNet's down/up split; the MDTv2 (model.DiT) "
                             "denoiser does not support it")
        cfg.model.ddpmconfig.extra["encoder_reuse"] = args.turbo
        print(f"turbo sampling: encoder reuse every {args.turbo} steps "
              "(non-exact, arXiv:2312.09608)")
    return SamplerService(
        cfg, service_batch=args.batch, resolution=args.resolution,
        linger_ms=args.linger_ms, use_ema=not args.no_ema, n_views=args.n_views,
        mesh_kwargs=mesh_kwargs or None, device=device,
    )


def main(argv=None):
    from ddmi_tpu_torch.serve.server import serve_http

    args = parse_args(argv)
    service = build_service(args)
    if not args.no_warmup:
        print("warming up (runs one batch)...", flush=True)
        service.warmup()
    serve_http(service, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
