"""KITTI Eigen evaluation CLI on the card (reference: model_test.py:124-159).

Evaluates one or more weight sets over the test split and prints the
7-metric table per set, with the flags and output of the JAX package's
`model_test.py`:

    python -m monodepth_tpu_torch.model_test --datapath ./dataset/kitti \
        --weights ./model_save/mono:22

Each --weights entry is `<dir>:<epoch>` pointing at per-module npz exports
(`encoder<epoch>.npz`, `decoder<epoch>.npz`, ...), written by the JAX
package's trainer or by `monodepth_tpu_torch.tools.convert_torch_weights`
from official Monodepth2 checkpoints. Two flags are added: `--device`
(default: the card; `cpu` runs the plain PyTorch path) and `--backend`.
Without a card and without `--device cpu` it raises.

Under torchrun (WORLD_SIZE > 1) each process sweeps its `process_slice`
of the split on its own device (the card LOCAL_RANK over NCCL; with
`--backend gloo` ranks may share a card), `evaluate_multihost` combines the
metrics, and rank 0 prints them and writes `--save_pred_disps` with the
disparities gathered back into the split's order, the file one process
writes:

    torchrun --nproc_per_node 2 -m monodepth_tpu_torch.model_test \
        --weights ./model_save/mono:22
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch.distributed as dist

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.evaluation.eigen import (
    detect_scales,
    eigen_metrics,
    evaluate_multihost,
    load_ground_truth,
    parse_weights_spec,
    predict_disparities,
    print_table,
    process_slice,
    state_from_modules,
)
from monodepth_tpu_torch.parallel.mesh import init_distributed
from monodepth_tpu_torch.training.state import resolve_device


def _in_split_order(disps: np.ndarray, count: int) -> np.ndarray:
    """Every process's disparities of its `process_slice`, interleaved back
    into the split's order (one `all_gather_object`)."""
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, disps)
    shape = next(p.shape[1:] for p in parts if len(p))
    out = np.empty((count,) + shape, np.float32)
    for rank, part in enumerate(parts):
        out[rank::len(parts)] = part
    return out


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
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="under torchrun: nccl (the default on cards, one rank a "
                        "card) or gloo (the CPU's default; on cards, ranks may "
                        "share one)")
    args = p.parse_args(argv)

    grouped = init_distributed(args.device, backend=args.backend)
    try:
        _sweep(args, grouped)
    finally:
        if grouped:
            dist.destroy_process_group()


def _sweep(args, grouped: bool) -> None:
    main = not grouped or dist.get_rank() == 0
    device = resolve_device(args.device)
    all_lines = kitti.readlines(os.path.join(
        args.splits, args.datatype, "test_files.txt"))
    lines = process_slice(all_lines) if grouped else all_lines
    if main:
        print(f">>> Testset length {len(all_lines)}")
    # a rank that fails still joins evaluate_multihost's all-gather, where
    # every rank then raises
    failure = None
    try:
        ground_truths = load_ground_truth(args.datapath, lines,
                                          cache_dir=args.gt_cache or None)
    except Exception as exc:  # noqa: BLE001 - see above
        if not grouped:
            raise
        failure, ground_truths = exc, []
    if main:
        print(">>> Loaded ground truth depth")
        if grouped:
            print(f">>> eval processes: {dist.get_world_size()} "
                  f"({dist.get_backend()})")

    for spec in args.weights:
        directory, epoch = parse_weights_spec(spec)
        scales = (args.scales or detect_scales(directory, epoch)
                  or (0, 1, 2, 3))
        cfg = Config(datapath=args.datapath, splits=args.splits,
                     datatype=args.datatype, num_layers=args.num_layers,
                     height=args.height, width=args.width, scales=scales,
                     weight_init=False)
        disps, error = np.zeros((0, cfg.height, cfg.width), np.float32), failure
        try:
            if error is None and lines:
                model = state_from_modules(cfg, directory, epoch, device)
                disps = predict_disparities(cfg, model, lines,
                                            eval_batch=args.eval_batch,
                                            device=device)
        except Exception as exc:  # noqa: BLE001 - see above
            if not grouped:
                raise
            error = exc
        if grouped:
            metrics = evaluate_multihost(cfg, None, lines, ground_truths,
                                         failure=error, disparities=disps)
        else:
            metrics = eigen_metrics(disps, ground_truths, cfg.datatype)
        if args.save_pred_disps:
            if grouped:
                disps = _in_split_order(disps, len(all_lines))
            # one file per weights set: a fixed path would keep only the
            # LAST set's predictions when several are evaluated
            path = args.save_pred_disps
            if len(args.weights) > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}_{os.path.basename(directory)}_{epoch}" \
                       f"{ext or '.npy'}"
            if main:
                np.save(path, disps)
                print(f">>> saved predicted disparities to {path} "
                      f"{disps.shape}")
        if main:
            print_table(spec, metrics)


if __name__ == "__main__":
    main()
