"""Single-image depth inference CLI.

    python -m monodepth_tpu_torch.tools.infer_image photo.jpg --weights ./model_save/mono:24

Counterpart of the JAX package's `tools/infer_image.py`, with its flags
plus `--device` (default: the card; `cpu` runs the plain PyTorch path);
the network runs in the config's precision, bf16. Loads the per-module
npz weights, runs `make_infer_step` at the model's resolution and writes
`<stem>_disp.png` (magma colormap, at the input's size) and
`<stem>_depth.npy` (metric depth at the model's resolution) next to each
input: the capability the Monodepth2 lineage exposes as `test_simple.py`
(the reference: the notebook `Tools` helpers, model_utility.py:239-297).
The infer path has no warp, so no custom kernel runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.evaluation.eigen import (
    detect_scales,
    parse_weights_spec,
    state_from_modules,
)
from monodepth_tpu_torch.training.state import resolve_device
from monodepth_tpu_torch.training.step import make_infer_step
from monodepth_tpu_torch.utils.visualize import colormap_disparity


def main(argv=None) -> dict:
    """Writes the two files of each image; returns {image path: (scaled
    disparity [H, W], depth [H, W])}."""
    p = argparse.ArgumentParser(description="single-image depth inference")
    p.add_argument("images", nargs="+")
    p.add_argument("--weights", required=True, help="<dir>:<epoch>")
    p.add_argument("--num_layers", default=18, type=int)
    p.add_argument("--height", default=192, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--scales", default=None,
                   type=lambda t: tuple(int(x) for x in t.replace(",", " ").split()),
                   help="training scales of the checkpoint; default: "
                        "auto-detected from the decoder export")
    p.add_argument("--min_depth", default=0.1, type=float)
    p.add_argument("--max_depth", default=100.0, type=float)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    args = p.parse_args(argv)

    directory, epoch = parse_weights_spec(args.weights)
    scales = (args.scales or detect_scales(directory, epoch)
              or (0, 1, 2, 3))
    cfg = Config(num_layers=args.num_layers, height=args.height,
                 width=args.width, scales=scales,
                 min_depth=args.min_depth, max_depth=args.max_depth,
                 weight_init=False)
    device = resolve_device(args.device)
    infer = make_infer_step(state_from_modules(cfg, directory, epoch, device), cfg,
                            device)

    out = {}
    for path in args.images:
        with Image.open(path) as img:
            rgb = img.convert("RGB")
            original = np.asarray(rgb)
            small = np.asarray(rgb.resize((cfg.width, cfg.height),
                                          Image.LANCZOS), dtype=np.float32)
        disp = infer(small[None] / 255.0)[0].float().cpu().numpy()
        # scaled disparity at the eval range -> metric depth at the
        # training range (`disparity_to_depth` in numpy)
        sigmoid = (disp - 1 / 80.0) / (1 / 1e-3 - 1 / 80.0)
        min_disp, max_disp = 1.0 / cfg.max_depth, 1.0 / cfg.min_depth
        depth = 1.0 / (min_disp + (max_disp - min_disp) * sigmoid)

        stem = os.path.splitext(path)[0]
        vis = colormap_disparity(disp)
        Image.fromarray(vis).resize(
            (original.shape[1], original.shape[0]),
            Image.BILINEAR).save(stem + "_disp.png")
        np.save(stem + "_depth.npy", depth)
        print(f"{path} -> {stem}_disp.png, {stem}_depth.npy "
              f"(depth {float(np.min(depth)):.1f}..{float(np.max(depth)):.1f} m)")
        out[path] = (disp, depth)
    return out


if __name__ == "__main__":
    main()
