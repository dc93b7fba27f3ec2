"""The train step's phases in a traced window, cut by the program's marks.

The port launches an empty kernel `phase_mark_<phase>` where each phase of
its train step begins (`monodepth_tpu_torch/training/phases.py`), and a
captured step keeps them as nodes of its graph, so every replay's device
trace carries them. Ordered by start, the marks cut the window into phase
windows, each from the end of a mark to the start of the next; the window
after the last mark and the one before the first (the work between two
calls: their inputs staged, their outputs cloned) belong to the last
mark's phase. A phase's busy time is the union of the other device
operations clipped to its windows, whatever their stream; its compute
time the same without NCCL's kernels (`kernel_classes.json`), which spin
while they wait for the other ranks; its wall time is the length of its
windows, bounded by the first and last device operation. All are per
call of the traced window.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, Optional

from benchmark.trace import Trace, kernel_class, union_us

MARK = re.compile(r"phase_mark_(\w+)")


@dataclasses.dataclass
class Phases:
    busy_ms: Dict[str, float]   # a call, by phase
    compute_ms: Dict[str, float]  # a call, by phase, NCCL's kernels left out
    wall_ms: Dict[str, float]   # a call, by phase
    marks_ms: float             # the marks' own device time a call


def split(trace: Trace) -> Optional[Phases]:
    """The phases of `trace`; None without marks, or where a phase's marks
    are not a whole number a call."""
    marks, ops = [], []
    for name, start, end in trace.device:
        found = MARK.search(name)
        (marks if found else ops).append((found.group(1) if found else name, start, end))
    if not marks:
        return None
    counts: Dict[str, int] = defaultdict(int)
    for name, _, _ in marks:
        counts[name] += 1
    if any(n % trace.calls for n in counts.values()):
        return None
    marks.sort(key=lambda m: m[1])
    first = min(s for _, s, _ in trace.device)
    last = max(e for _, _, e in trace.device)
    windows = [(marks[-1][0], first, marks[0][1])]
    windows += [(m[0], m[2], n[1]) for m, n in zip(marks, marks[1:])]
    windows.append((marks[-1][0], marks[-1][2], last))
    clipped, wall = defaultdict(list), defaultdict(float)
    for name, lo, hi in windows:
        wall[name] += max(0.0, hi - lo)
    starts = [lo for _, lo, _ in windows]
    for op, start, end in ops:
        i = max(0, bisect.bisect_right(starts, start) - 1)
        while i < len(windows) and windows[i][1] < end:
            name, lo, hi = windows[i]
            if start < hi:
                clipped[name].append((op, max(start, lo), min(end, hi)))
            i += 1
    per_call = lambda us: us / 1e3 / trace.calls  # noqa: E731
    own = lambda spans: [s for s in spans if kernel_class(s[0]) != "nccl"]  # noqa: E731
    return Phases(busy_ms={name: per_call(union_us(clipped[name])) for name in wall},
                  compute_ms={name: per_call(union_us(own(clipped[name]))) for name in wall},
                  wall_ms={name: per_call(us) for name, us in wall.items()},
                  marks_ms=per_call(union_us(marks)))


def busy_ms(run: dict, *names: str, nccl: bool = True) -> Optional[float]:
    """The busy ms a call of the phases `names` in the run's trace (their
    compute ms without `nccl`); None where the trace has no phases or none
    of these."""
    trace = run.get("trace")
    phases = None if trace is None else split(trace)
    if phases is None or not any(n in phases.busy_ms for n in names):
        return None
    table = phases.busy_ms if nccl else phases.compute_ms
    return sum(table.get(n, 0.0) for n in names)
