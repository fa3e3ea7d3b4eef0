"""FID protocol tools (counterpart of ddmi_tpu/cli/precompute_fid.py):

1. `precompute`: walk an image folder, take the InceptionV3 pool features of
   every image on the device and save their (mu, sigma) statistics to an
   .npz (the reference's precompute_fid_statistics);
2. `preprocess`: symmetrize -> bilinear resize -> [0, 255] uint8 re-dump of
   an image folder (the reference's prepare_image, the FID input
   normalisation).

Usage:
  python -m ddmi_tpu_torch.cli.precompute_fid precompute --data <folder> \
      --out fid_stats.npz [--size 256] [--max-samples 50000] \
      [--inception-weights converted.npz] [--device cuda]
  python -m ddmi_tpu_torch.cli.precompute_fid preprocess --data <in> --out <folder> \
      --size 256

The weights file is the JAX package's format: an .npz whose "params" holds
the flax tree (interop.py::inception_from_jax maps it).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_EXTS = {".png", ".jpg", ".jpeg", ".webp"}


def _iter_images(root: str, batch: int, size: int):
    """Batches (b, size, size, 3) float32 in [0, 1] of the folder's images
    in sorted order, each resized as jax.image.resize's bilinear resizes
    (core/coords.py::resize_bilinear)."""
    from PIL import Image

    from ddmi_tpu_torch.core.coords import resize_bilinear

    files = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root) for f in fs
                   if os.path.splitext(f)[1].lower() in _EXTS)
    buf = []
    for i, f in enumerate(files):
        im = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        buf.append(resize_bilinear(torch.from_numpy(im), (size, size)).numpy())
        if len(buf) == batch or i == len(files) - 1:
            yield np.stack(buf)
            buf = []


def precompute(args):
    from ddmi_tpu_torch.evals.fid import FIDScorer, activation_statistics
    from ddmi_tpu_torch.evals.inception import InceptionV3
    from ddmi_tpu_torch.interop import inception_from_jax

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = InceptionV3()
    if args.inception_weights and os.path.exists(args.inception_weights):
        model.load_state_dict(inception_from_jax(
            np.load(args.inception_weights, allow_pickle=True)["params"].item()))
    else:
        print("WARNING: no converted InceptionV3 weights (--inception-weights); statistics "
              "use a random-init network and are NOT comparable to published FID numbers")
    scorer = FIDScorer(model, batch_size=args.batch_size, device=args.device)
    feats = []
    n = 0
    for batch in _iter_images(args.data, args.batch_size, args.size):
        feats.append(scorer.features([batch]))
        n += batch.shape[0]
        if args.max_samples and n >= args.max_samples:
            break
    mu, sigma = activation_statistics(np.concatenate(feats)[: args.max_samples])
    np.savez(args.out, mu=mu, sigma=sigma)
    print(f"saved FID statistics for {n} images -> {args.out}")


def preprocess(args):
    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    n = 0
    for dp, _, fs in os.walk(args.data):
        for f in sorted(fs):
            if os.path.splitext(f)[1].lower() not in _EXTS:
                continue
            im = Image.open(os.path.join(dp, f)).convert("RGB")
            # prepare_image: symmetrize -> [0, 255] -> bilinear resize
            arr = (np.asarray(im, np.float32) - 127.5) / 127.5
            im2 = Image.fromarray(np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)).resize(
                (args.size, args.size), Image.BILINEAR)
            im2.save(os.path.join(args.out, f"{n:08d}.png"))
            n += 1
    print(f"preprocessed {n} images -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser("ddmi_tpu_torch.precompute_fid")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("precompute")
    pc.add_argument("--data", required=True)
    pc.add_argument("--out", required=True)
    pc.add_argument("--size", type=int, default=256)
    pc.add_argument("--batch-size", type=int, default=64)
    pc.add_argument("--max-samples", type=int, default=50000)
    pc.add_argument("--inception-weights", default=None)
    pc.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the host)")
    pp = sub.add_parser("preprocess")
    pp.add_argument("--data", required=True)
    pp.add_argument("--out", required=True)
    pp.add_argument("--size", type=int, default=256)
    args = p.parse_args(argv)
    if args.cmd == "precompute":
        precompute(args)
    else:
        preprocess(args)


if __name__ == "__main__":
    main()
