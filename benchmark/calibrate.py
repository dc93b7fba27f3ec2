"""The readings a train cell's limits are set from, on the card, in one
process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 3]

For each seed it builds the cell's set-up as a run does and reads each
number of the check for
- the program (its first three steps) against the reference: the lower
  reading is the largest over the seeds;
- the reference at the program's stated precision (its family
  reference's `PROGRAM_PRECISION`), and which leaf reads worst there and
  in the program, and the first gradient's median gap in each of the
  family's `NETWORKS`: how far that rounding alone moves each number,
  and where;
- the control, the reference in the precision below the configuration's,
  and each part of it (the reference's `CONTROLS`; Monodepth2's: fp8
  convolutions alone, a bf16 loss stack alone);
- the faults a run can have, planted in the reference: half of each
  batch left out (the mean over the rest); on several cards, rank 0's
  items alone (the exchange left out); and two that break the replays
  alone: their input left stale (every step on the first batch) and their
  update lost (steps 2 and 3 at rate 0).
On a cell of several cards the program's readings come from its runs;
here the reference alone reads the rest at the global batch. The control
and the faults run on the first `--control-seeds` seeds. One JSON line a
seed, on standard output.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, train  # noqa: E402
from benchmark.manifest import cell as load_cell  # noqa: E402


def _steps(t) -> check.Steps:
    """A reference `Trajectory` as the check reads the program's steps."""
    return check.Steps(t.losses, t.grad1, t.grad2, t.params, t.stats, t.disp1, t.params1)


def network_medians(networks, grad1, ref) -> dict:
    """The first gradient's median leaf gap within each network (by its
    state_dict prefix)."""
    gaps = check.leaf_gaps(grad1, {k: v.cpu() for k, v in ref.grad1.items()})
    return {n[:-1]: statistics.median(v for k, v in gaps.items() if k.startswith(n))
            for n in networks}


def train_seed(cell, seed: int, device, faults: bool) -> dict:
    if cell.chips > 1:
        s = train.inputs(cell, seed, device, cell.chips)
        s.state_dict = {k: v.cpu() for k, v in s.state_dict.items()}
        first = None
    else:
        s = train.make(cell, seed, device)
        first = train.first_steps(s)
        s.step = s.state = None
        train.free(device)
    reference = s.family.reference
    train.exact_matmuls()
    ref = train.reference_steps(s, reference.F32, device)
    numbers = lambda steps, leaves=None: check.train_numbers(  # noqa: E731
        steps, ref, s.state_dict, train.reference_replay(s, steps.params1, device), leaves)
    out, worst = {}, {}
    if first is not None:
        worst["program"] = {}
        out["program"] = numbers(first, worst["program"])
        out["losses"] = {"program": first.losses, "reference": ref.losses}
        worst["program_precision"] = {}
        same = train.reference_steps(s, reference.PROGRAM_PRECISION, device)
        out["program_precision"] = numbers(_steps(same), worst["program_precision"])
        out["worst_leaves"] = worst
        networks = s.family.NETWORKS
        out["grad1_network_medians"] = {
            "program": network_medians(networks, first.grad1, ref),
            "program_precision": network_medians(networks, same.grad1, ref)}
    if not faults:
        return out
    for name, numerics in reference.CONTROLS.items():
        out[name] = numbers(_steps(train.reference_steps(s, numerics, device)))
    B = s.batches[0]["frames"].shape[0]
    plant = {"half_batch": dict(items=slice(0, B // 2)),
             "stale_input": dict(ring=[0] * train.WARM_STEPS),
             "replays_unchanged": dict(rates=[s.conf["learning_rate"]]
                                       + [0.0] * (train.WARM_STEPS - 1))}
    if cell.chips > 1:
        plant["one_rank"] = dict(items=slice(0, s.conf["batch"]))
    for name, how in plant.items():
        out[name] = numbers(_steps(train.reference_steps(s, reference.F32, device, **how)))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    for n, seed in enumerate(args.seeds):
        start = time.perf_counter()
        out = train_seed(cell, seed, device, n < args.control_seeds)
        out.update(workload=cell.name, seed=seed, seconds=time.perf_counter() - start)
        print(json.dumps(out), flush=True)
        train.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
