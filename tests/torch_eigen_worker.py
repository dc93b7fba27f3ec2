"""One rank of the port's Eigen sweep over a process group on the CPU
(gloo), for tests/test_torch_eigen_mesh.py. Imports no jax. Run under
torchrun:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_eigen_worker.py OUT_DIR DATAPATH SPLITS WEIGHTS EPOCH

Each rank joins the group (`init_distributed`, 60 s collective timeout),
sweeps its `process_slice` of the test split with `evaluate_multihost` (f32,
64x96, scales (0, 1), eval_batch 2), then runs the failure contract twice:
rank 1 passes a `failure`, and rank 0's sweep fails inside (a ground truth
short). It writes OUT_DIR/rank<r>.json: its lines, the metrics, and the
message each failing call raised on this rank."""

import json
import os
import sys

import torch
import torch.distributed as dist

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.kitti import readlines
from monodepth_tpu_torch.evaluation import eigen
from monodepth_tpu_torch.parallel import init_distributed


def main(out, datapath, splits, weights, epoch) -> None:
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60)
    rank = dist.get_rank()
    cfg = Config(datapath=datapath, splits=splits, height=64, width=96, scales=(0, 1),
                 precision="f32", weight_init=False)
    lines = eigen.process_slice(readlines(os.path.join(splits, "kitti_eigen_zhou",
                                                       "test_files.txt")))
    gts = eigen.load_ground_truth(datapath, lines)
    model = eigen.state_from_modules(cfg, weights, int(epoch), "cpu")
    metrics = eigen.evaluate_multihost(cfg, model, lines, gts, eval_batch=2, num_workers=1)
    raised = {}
    for case, kwargs in (("failure", {"failure": ValueError("boom") if rank == 1 else None}),
                         ("inside", {"local_gts": gts[:-1] if rank == 0 else gts})):
        args = {"local_gts": gts, **kwargs}
        try:
            eigen.evaluate_multihost(cfg, model, lines, eval_batch=2, num_workers=1, **args)
            raised[case] = None
        except RuntimeError as exc:
            raised[case] = str(exc)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "lines": lines, "metrics": metrics, "raised": raised}, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
