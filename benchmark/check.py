"""The numbers that decide `correct`, each against its limit.

The relative gap of each of the first three steps' losses (`loss1` of
the eager first call, `loss2` and `loss3` of the captured step's first
two replays, where both sides train on from their own weights); by the
worst image, the relative L2 gap of the first step's finest disparity
(`disp1`: the depth network alone); and by the worst leaf, the gap
between the program's and the reference's norms, over the larger of the
reference's norm of that leaf and of the median leaf: of the first
step's gradient (`grad1`, the program's read from Adam's first moments
after the first call), of each parameter's change in the first step
(`update1`) and over the three steps (`change3`), and of the batch-norm
running statistics' change (`stats3`); and the same gaps' median over
the leaves (`grad1_median`, ...).

The first replay is also judged on the program's own weights: from the
parameters the program holds after its first call, the reference takes
the second step's loss and gradient on the same batch and noise, and
`replay_loss` and `replay_grad` (with `replay_grad_median`) compare the
program's second loss and gradient with them. Adam's first update moves
each weight by about the rate, whatever its gradient's size, so where a
gradient cancels the two sides' rounding sends weights opposite ways,
and on some seeds the second step's loss then differs by as much as
the control's; from one set of weights the replay's forward and
backward are compared alone. Leaves whose first gradient in the
reference is under a thousandth of the median leaf's move under Adam by
round-off alone: `update1` and `change3` leave them out.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
from typing import Dict, List

import torch

Tensor = torch.Tensor
TINY_GRADIENT = 1e-3


@dataclasses.dataclass
class Steps:
    """What the program's first three steps give, as the reference's
    `Trajectory` holds it: the losses, the first two gradients, the first
    step's finest disparity [B', 1, H, W] (of this rank's B' items: the
    batch's first on rank 0), the parameters after the first step, and
    the parameters and running statistics after the third step (on the
    host)."""
    losses: List[float]
    grad1: Dict[str, Tensor]
    grad2: Dict[str, Tensor]
    params: Dict[str, Tensor]
    stats: Dict[str, Tensor]
    disp1: Tensor
    params1: Dict[str, Tensor]


def leaf_gaps(ours: Dict[str, Tensor], ref: Dict[str, Tensor], keep=None) -> Dict[str, float]:
    """{leaf: |‖ours‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)}."""
    norms = {k: float(ref[k].double().norm()) for k in ref if keep is None or k in keep}
    median = statistics.median(norms.values())
    return {k: abs(float(ours[k].double().norm()) - n) / max(n, median, 1e-30)
            for k, n in norms.items()}


def train_numbers(ours: Steps, traj, start: Dict[str, Tensor], replay,
                  leaves: dict | None = None) -> Dict[str, float]:
    """The train cell's numbers; `traj` the reference's `Trajectory`,
    `start` the weights both began from, `replay` the reference's (loss,
    {leaf: gradient}) of the second step from `ours.params1`. `leaves`,
    when given, gets the worst leaf of each leaf-wise number."""
    out = {f"loss{k}": abs(a - b) / abs(b)
           for k, (a, b) in enumerate(zip(ours.losses, traj.losses), 1)}
    ref_disp = traj.disp1.cpu()[:ours.disp1.shape[0]]
    out["disp1"] = float(image_gaps(ours.disp1.cpu(), ref_disp).max())
    replay_loss, replay_grad = replay
    out["replay_loss"] = abs(ours.losses[1] - replay_loss) / abs(replay_loss)
    host = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    ref_grad = host(traj.grad1)
    median = statistics.median(float(v.double().norm()) for v in ref_grad.values())
    moved = {k for k, v in ref_grad.items() if float(v.double().norm()) >= TINY_GRADIENT * median}
    change = lambda p: {k: v.cpu().double() - start[k].double() for k, v in p.items()}  # noqa: E731
    for name, gaps in (("grad1", leaf_gaps(ours.grad1, ref_grad)),
                       ("update1", leaf_gaps(change(ours.params1), change(traj.params1), moved)),
                       ("replay_grad", leaf_gaps(ours.grad2, host(replay_grad))),
                       ("change3", leaf_gaps(change(ours.params), change(traj.params), moved)),
                       ("stats3", leaf_gaps(change(ours.stats), change(traj.stats)))):
        out[name] = max(gaps.values())
        out[f"{name}_median"] = statistics.median(gaps.values())
        if leaves is not None:
            leaves[name] = max(gaps, key=gaps.get)
    return out


def image_gaps(ours: Tensor, ref: Tensor) -> Tensor:
    """Per image [B]: |ours - ref| / |ref| over its pixels."""
    d = (ours.double() - ref.double()).flatten(1).norm(dim=1)
    return d / ref.double().flatten(1).norm(dim=1)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, failed, {name: {value, limit}}): every number at or under
    its limit, and finite. A number without a limit is reported, not
    judged."""
    report, failed = {}, 0
    for name, value in numbers.items():
        limit = limits.get(name)
        report[name] = {"value": value, "limit": limit}
        if limit is not None and not value <= limit:
            failed += 1
    return failed == 0, failed, report


def print_report(report: dict) -> None:
    for name, r in report.items():
        print(f"check {name}: {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
