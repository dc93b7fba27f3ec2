"""KITTI Eigen evaluation CLI on the card (reference: model_test.py:124-159).

Evaluates one or more weight sets over the test split and prints the
7-metric table per set, with the flags and output of the JAX package's
`model_test.py`:

    python -m monodepth_tpu_torch.model_test --datapath ./dataset/kitti \
        --weights ./model_save/mono:22

Each --weights entry is `<dir>:<epoch>` pointing at per-module npz exports
(`encoder<epoch>.npz`, `decoder<epoch>.npz`, ...), written by the JAX
package's trainer or by `monodepth_tpu_torch.tools.convert_torch_weights`
from official Monodepth2 checkpoints. One flag is added: `--device`
(default: the card; `cpu` runs the plain PyTorch path). Without a card and
without `--device cpu` it raises. The sweep runs on one device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.evaluation.eigen import (
    detect_scales,
    eigen_metrics,
    load_ground_truth,
    parse_weights_spec,
    predict_disparities,
    print_table,
    state_from_modules,
)
from monodepth_tpu_torch.training.state import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="KITTI Eigen evaluation")
    p.add_argument("--datapath", default="./dataset/kitti", type=str)
    p.add_argument("--splits", default="./splits", type=str)
    # kitti_benchmark is train-only: its test_files.txt has no raw-drive
    # paths to project GT from
    p.add_argument("--datatype", default="kitti_eigen_zhou", type=str,
                   choices=["kitti_eigen_full", "kitti_eigen_zhou"])
    p.add_argument("--num_layers", default=18, type=int)
    p.add_argument("--height", default=192, type=int)
    p.add_argument("--width", default=640, type=int)
    p.add_argument("--scales", default=None,
                   type=lambda t: tuple(int(x) for x in t.replace(",", " ").split()),
                   help="training scales of the checkpoint; default: "
                        "auto-detected from the decoder export")
    p.add_argument("--eval_batch", default=16, type=int)
    p.add_argument("--weights", nargs="+", required=True,
                   help="<dir>:<epoch> per weight set")
    p.add_argument("--save_pred_disps", default="", type=str,
                   help="write predicted disparities [N,H,W] to this .npy")
    p.add_argument("--gt_cache", default="./model_save/gt_cache_eval", type=str,
                   help="cache dir for projected velodyne GT ('' disables)")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    lines = kitti.readlines(os.path.join(
        args.splits, args.datatype, "test_files.txt"))
    print(f">>> Testset length {len(lines)}")
    ground_truths = load_ground_truth(args.datapath, lines,
                                      cache_dir=args.gt_cache or None)
    print(">>> Loaded ground truth depth")

    for spec in args.weights:
        directory, epoch = parse_weights_spec(spec)
        scales = (args.scales or detect_scales(directory, epoch)
                  or (0, 1, 2, 3))
        cfg = Config(datapath=args.datapath, splits=args.splits,
                     datatype=args.datatype, num_layers=args.num_layers,
                     height=args.height, width=args.width, scales=scales,
                     weight_init=False)
        model = state_from_modules(cfg, directory, epoch, device)
        disps = predict_disparities(cfg, model, lines,
                                    eval_batch=args.eval_batch, device=device)
        if args.save_pred_disps:
            # one file per weights set: a fixed path would keep only the
            # LAST set's predictions when several are evaluated
            path = args.save_pred_disps
            if len(args.weights) > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}_{os.path.basename(directory)}_{epoch}" \
                       f"{ext or '.npy'}"
            np.save(path, disps)
            print(f">>> saved predicted disparities to {path} "
                  f"{disps.shape}")
        metrics = eigen_metrics(disps, ground_truths, cfg.datatype)
        print_table(spec, metrics)


if __name__ == "__main__":
    main()
