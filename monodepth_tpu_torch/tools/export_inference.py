"""Export depth inference as a self-contained `torch.export` program.

    python -m monodepth_tpu_torch.tools.export_inference --weights <dir>:<epoch> \
        --height 192 --width 640 [--num_layers 18] [--precision bf16] \
        [--batch 0] [--device cuda] --out depth_infer.pt2

Counterpart of the JAX package's `tools/export_inference.py` (a StableHLO
artifact from `jax.export`): `training.step.DepthInference`, the depth
forward of `make_infer_step` (encoder -> decoder -> scaled disparity at the
eval range, reference model_test.py:80-83) in eval mode, exported once by
`torch.export` with the weights held in the program and a dynamic batch
dimension, saved with `torch.export.save`. Serving loads it without this
package's model code or checkpoint plumbing:

    program = torch.export.load("depth_infer.pt2")
    disp = program.module()(images)   # images [b, H, W, 3] f32 in [0, 1]

The program runs on the device it was exported on (`--device`, default
the card). Inference is depth-only: it has no warp, so no custom kernel
is in the program, and it runs wherever PyTorch runs.
"""

from __future__ import annotations

import argparse

import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.evaluation.eigen import (
    detect_scales,
    parse_weights_spec,
    state_from_modules,
)
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.training.state import resolve_device
from monodepth_tpu_torch.training.step import DepthInference


def build_exported(cfg: Config, model: Monodepth, batch: int | None = None,
                   device=None) -> torch.export.ExportedProgram:
    """`torch.export` of `DepthInference(model)` (the infer step's
    function, the model in eval mode). `batch=None` exports a dynamic
    batch dimension (1 to 1024); an integer pins it."""
    device = resolve_device(device)
    module = DepthInference(model.to(device).eval(), cfg)
    example = torch.rand(batch or 2, cfg.height, cfg.width, 3, device=device)
    dynamic = None if batch else {"images": {0: torch.export.Dim("batch", min=1, max=1024)}}
    with torch.no_grad():
        return torch.export.export(module, (example,), dynamic_shapes=dynamic)


def main(argv=None) -> torch.export.ExportedProgram:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", required=True, help="<dir>:<epoch>")
    p.add_argument("--height", default=192, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--num_layers", default=18, type=int)
    p.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--batch", default=0, type=int,
                   help="0 = dynamic batch dimension")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    directory, epoch = parse_weights_spec(args.weights)
    scales = detect_scales(directory, epoch) or (0, 1, 2, 3)
    cfg = Config(height=args.height, width=args.width,
                 num_layers=args.num_layers, precision=args.precision,
                 scales=scales, weight_init=False)
    device = resolve_device(args.device)
    model = state_from_modules(cfg, directory, epoch, device)
    exported = build_exported(cfg, model, batch=args.batch or None, device=device)
    torch.export.save(exported, args.out)
    spec = exported.graph_signature.user_inputs
    print(f">>> exported depth inference: inputs {spec} -> {args.out} "
          f"({device}, {args.precision})")
    return exported


if __name__ == "__main__":
    main()
