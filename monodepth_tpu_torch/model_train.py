"""Train CLI on the card (reference: model_train.py:100-101,
`trainer(options()).train()`):

    python -m monodepth_tpu_torch.model_train --pose_type separate \
        --datatype kitti_eigen_zhou --batch 12

The flags are those of the JAX package's `model_train.py`
(`monodepth_tpu_torch/config.py`), plus `--device` (default: the card;
`cpu` runs the plain PyTorch path). Every pose wiring trains:
`--pose_type separate|shared|posecnn`, `--pose_frames 2|all`, and
`--dataset kitti_stereo` for stereo (frames "0 s") or mono+stereo (the
default frames plus "s", which `Config.validate` adds); the loader then
feeds each batch's `stereo_T`. Without a card and without
`--device cpu` it raises. The run writes under `<save_root>/<save>/`:
`state_<epoch>.pt`, the module exports `<module><epoch + 1>.npz` (which
`python -m monodepth_tpu_torch.model_test --weights <dir>:<epoch>`
reads), `metrics.jsonl` and `loss/*.npy`.

On a process mesh, one process per rank, data-parallel over all of them:

    torchrun --nproc_per_node 2 -m monodepth_tpu_torch.model_train \
        --data_parallel 2 --batch 12 ...

Each rank takes the card LOCAL_RANK over NCCL. `--backend gloo` lets the
ranks share a card (LOCAL_RANK modulo the card count), with collectives
staged through host memory; with `--device cpu` the ranks run gloo on the
CPU. Rank 0 writes the files and prints.
"""

from __future__ import annotations

import argparse
import gc

import torch.distributed as dist

from monodepth_tpu_torch.config import options
from monodepth_tpu_torch.parallel.mesh import init_distributed
from monodepth_tpu_torch.training.loop import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="under torchrun: nccl (the default on cards, one rank a "
                        "card) or gloo (the CPU's default; on cards, ranks may "
                        "share one)")
    args, rest = p.parse_known_args(argv)
    grouped = init_distributed(args.device, backend=args.backend)
    try:
        return Trainer(options(rest), device=args.device).train()
    finally:
        if grouped:
            gc.collect()  # the Trainer's CUDA graphs (NCCL inside) before the group
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
