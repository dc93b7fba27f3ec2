"""Export predicted camera trajectories (odometry) as poses.npy.

    python -m monodepth_tpu_torch.tools.export_poses --datapath ./dataset/kitti \
        --splits ./splits --datatype kitti_eigen_zhou --split test \
        --weights ./model_save/mono:24 --out poses.npy

Counterpart of the JAX package's `tools/export_poses.py`, with its flags
plus `--device` (default: the card; `cpu` runs the plain PyTorch path);
the network runs in the config's precision, bf16. Runs the pose network
over consecutive frame pairs of each drive in the split and chains the
relative SE(3) transforms into global camera-to-world poses, saved as
[N, 4, 4] float32: the artifact format the reference ships as
`model_save/official_monostereo/poses.npy` (1590x4x4), which
`python -m monodepth_tpu_torch.tools.evaluate_poses` reads. The pose path
has no warp, so no custom kernel runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.data.dataset import KittiDataset
from monodepth_tpu_torch.evaluation.eigen import (
    detect_scales,
    parse_weights_spec,
    state_from_modules,
)
from monodepth_tpu_torch.ops.geometry import transform_from_parameters
from monodepth_tpu_torch.training.state import resolve_device


def consecutive_pairs(lines):
    """(folder, frame, side) of every line whose next frame in the same
    drive and camera is also a line, in (drive, side, frame) order."""
    keyed = sorted((kitti.parse_split_line(line) for line in lines),
                   key=lambda t: (t[0], t[2], t[1]))
    return [(f0, i0, s0) for (f0, i0, s0), (f1, i1, s1)
            in zip(keyed, keyed[1:]) if f0 == f1 and s0 == s1 and i1 == i0 + 1]


def main(argv=None) -> np.ndarray:
    """Writes `--out` and returns the poses."""
    p = argparse.ArgumentParser(description="pose (odometry) export")
    p.add_argument("--datapath", default="./dataset/kitti", type=str)
    p.add_argument("--splits", default="./splits", type=str)
    p.add_argument("--datatype", default="kitti_eigen_zhou", type=str)
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--weights", required=True, help="<dir>:<epoch>")
    p.add_argument("--num_layers", default=18, type=int)
    p.add_argument("--height", default=192, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--scales", default=None,
                   type=lambda t: tuple(int(x) for x in t.replace(",", " ").split()),
                   help="training scales of the checkpoint; default: "
                        "auto-detected from the decoder export")
    p.add_argument("--pose_type", default="separate",
                   choices=["separate", "shared", "posecnn"])
    p.add_argument("--batch", default=16, type=int)
    p.add_argument("--out", default="poses.npy", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    args = p.parse_args(argv)

    directory, epoch = parse_weights_spec(args.weights)
    scales = (args.scales or detect_scales(directory, epoch)
              or (0, 1, 2, 3))
    # frame_ids (0, 1): one pose pair a forward, poses[1] the second frame
    cfg = Config(datapath=args.datapath, splits=args.splits,
                 datatype=args.datatype, num_layers=args.num_layers,
                 height=args.height, width=args.width, scales=scales,
                 pose_type=args.pose_type, weight_init=False, frame_ids=(0, 1))
    device = resolve_device(args.device)
    model = state_from_modules(cfg, directory, epoch, device)

    lines = kitti.readlines(os.path.join(
        cfg.splits, cfg.datatype, f"{args.split}_files.txt"))
    pairs = consecutive_pairs(lines)
    if not pairs:
        raise SystemExit("no consecutive frame pairs in this split")
    dataset = KittiDataset(cfg.datapath, lines, is_training=False,
                           frame_ids=(0, 1), height=cfg.height,
                           width=cfg.width, load_depth=False)

    relatives = []
    frames = np.empty((args.batch, 2, cfg.height, cfg.width, 3), np.uint8)
    for start in range(0, len(pairs), args.batch):
        chunk = pairs[start:start + args.batch]
        for j, (folder, index, side) in enumerate(chunk):
            frames[j, 0] = dataset._load_image(folder, index, side, False)
            frames[j, 1] = dataset._load_image(folder, index + 1, side, False)
        images = torch.from_numpy(frames.astype(np.float32) / 255.0).to(device)
        # the network under bf16 autocast, the geometry in f32
        with torch.inference_mode():
            with torch.autocast(device.type, dtype=torch.bfloat16,
                                enabled=cfg.precision == "bf16"):
                _, poses = model(images)
            aa, t = poses[1]
            rel = transform_from_parameters(aa.float(), t.float(), invert=False)
        relatives.append(rel[:len(chunk)].cpu().numpy())
    relatives = np.concatenate(relatives)

    # chain camera-to-camera transforms into global poses
    poses = [np.eye(4, dtype=np.float32)]
    for rel in relatives:
        poses.append(poses[-1] @ np.linalg.inv(rel))
    poses = np.stack(poses).astype(np.float32)
    np.save(args.out, poses)
    print(f"{len(poses)} poses -> {args.out} (shape {poses.shape})")
    return poses


if __name__ == "__main__":
    main()
