"""The traced window: `torch.profiler` over a few calls, and what the
per-layer readers take from it.

Device time is the kernels' and copies' intervals on the device timeline.
Busy time is the union of those intervals (the time in which any
operation ran; streams that overlap count once). Each device operation
falls in the first class of `kernel_classes.json` with a pattern in its
name (case ignored); what no class claims is `elementwise`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

CLASSES = json.loads((Path(__file__).with_name("kernel_classes.json")).read_text())
NAME_CHARS = 120

Span = Tuple[str, float, float]  # (name, start us, end us)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, patterns in CLASSES.items():
        if any(p.lower() in low for p in patterns):
            return cls
    return "elementwise"


def union_us(spans: List[Span]) -> float:
    total, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


@dataclasses.dataclass
class Trace:
    calls: int
    window_s: float
    device: List[Span]
    host: List[Span]

    @property
    def busy_s(self) -> float:
        return union_us(self.device) / 1e6

    def class_ms_per_call(self, *classes: str) -> Optional[float]:
        """Device ms a call in the given classes; None where none ran."""
        hits = [e - s for n, s, e in self.device if kernel_class(n) in classes]
        return sum(hits) / 1e3 / self.calls if hits else None

    def breakdown(self, named_gaps: int = 200) -> Dict[str, list]:
        """The ten device operations that took most time, and the ten host
        operations during which the device stood idle longest, in seconds
        over the traced window. Each of the `named_gaps` longest idle gaps
        is named by the shortest host operation that spans its middle."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[n[:NAME_CHARS]] += (e - s) / 1e6
        found = []
        reach = min((h[1] for h in self.host), default=0.0)
        for _, start, end in sorted(self.device, key=lambda d: d[1]):
            if start > reach:
                found.append((start - reach, (start + reach) / 2))
            reach = max(reach, end)
        starts = np.array([h[1] for h in self.host])
        ends = np.array([h[2] for h in self.host])
        gaps: Dict[str, float] = defaultdict(float)
        for length, mid in sorted(found, reverse=True)[:named_gaps]:
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = "(no host op)" if not inside.size else \
                self.host[inside[np.argmin(ends[inside] - starts[inside])]][0]
            gaps[name[:NAME_CHARS]] += length / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def capture(call: Callable[[int], object], calls: int) -> Trace:
    """Profile `calls` calls of call(i), the device drained before and
    after; the window is the host's time from the first call to the
    drain."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(calls):
            call(i)
        torch.cuda.synchronize()
        window = time.perf_counter() - start
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type != cuda]
    # a host range also shows on the device timeline as an annotation
    ranges = {h[0] for h in host}
    device = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type == cuda and e.name not in ranges]
    return Trace(calls, window, device, host)
