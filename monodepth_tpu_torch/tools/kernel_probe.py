"""Probe the warp sampler's gather building blocks through the port's kernels.

    python -m monodepth_tpu_torch.tools.kernel_probe [--device cpu]

The counterpart of `tools/pallas_probe.py`, on the same inputs (numpy
seeds 0-3) and printing the same lines. Each probe goes through its
kernel in `monodepth_tpu_torch/ops/cuda/probes.py` on the card, or
through the kernel's plain version with `--device cpu`:
  A  take_along_axis on one [8, 128] table
  B  full-row gather, out-of-range indices giving 0, [8, W]
  C  a row sum whose bounds the kernel reads on the device
  D  throughput: n_y row gathers per 8-row slab over a [12, 192, 640]
     warp's worth, as a dependent chain (each call's indices are
     |idx0 + int(mean of the previous output)|): 2 calls to warm up,
     then 50 timed by CUDA events on the card (the host clock on the CPU)
Without a card and without `--device cpu` it raises. A probe that raises
or prints WRONG fails the run.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from monodepth_tpu_torch.ops.cuda import probes
from monodepth_tpu_torch.training.state import resolve_device


class ProbeResult(NamedTuple):
    ok: bool                   # A-C: the output is right; D: the time is finite
    out: torch.Tensor          # the probe's output (D: of the last timed call)
    ms: Optional[float] = None  # D: ms per call of the chain


def inputs_a():
    """P-A's (tab [8, 128] f32, idx [8, 128] i32) as numpy arrays."""
    tab = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    return tab, np.random.default_rng(0).integers(0, 128, (8, 128)).astype(np.int32)


def inputs_b(W: int = 640):
    """P-B's (row [8, W] f32, the same row on every sublane; idx [8, W] i32)."""
    rng = np.random.default_rng(1)
    row = np.tile(rng.uniform(0, 1, (1, W)), (8, 1)).astype(np.float32)
    return row, rng.integers(0, W, (8, W)).astype(np.int32)


def inputs_c(H: int = 192, W: int = 640):
    """P-C's (src [H, W] f32, lim [2] i32 = (50, 61))."""
    src = np.random.default_rng(2).uniform(0, 1, (H, W)).astype(np.float32)
    return src, np.array([50, 61], np.int32)


def inputs_d(B: int = 12, H: int = 192, W: int = 640):
    """P-D's (src [B, H, W] f32, idx [B, H, W] i32)."""
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    return src, rng.integers(0, W, (B, H, W)).astype(np.int32)


def _on(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _report(line: str, ok: bool) -> None:
    print(f"{line}: {'OK' if ok else 'WRONG'}", flush=True)


def probe_a(device="cuda") -> ProbeResult:
    """Single-table lane gather."""
    tab, idx = inputs_a()
    out = probes.take_along_axis(*_on(resolve_device(device), tab, idx))
    ok = np.array_equal(out.cpu().numpy(), np.take_along_axis(tab, idx, axis=1))
    _report("A take_along_axis [8,128]", ok)
    return ProbeResult(ok, out)


def probe_b(W: int = 640, device="cuda") -> ProbeResult:
    row, idx = inputs_b(W)
    out = probes.row_gather(*_on(resolve_device(device), row, idx))
    ok = np.allclose(out.cpu().numpy(), row[0][idx])
    _report(f"B full-row candidate gather W={W}", ok)
    return ProbeResult(ok, out)


def probe_c(H: int = 192, W: int = 640, device="cuda") -> ProbeResult:
    """Dynamic trip count + dynamic row reads: sum rows ymin..ymax."""
    src, lim = inputs_c(H, W)
    out = probes.row_sum(*_on(resolve_device(device), src, lim))
    ok = np.allclose(out.cpu().numpy()[0], src[50:61].sum(0))
    _report("C dynamic fori_loop + row reads", ok)
    return ProbeResult(ok, out)


def probe_d(B: int = 12, H: int = 192, W: int = 640, n_y: int = 4,
            device="cuda") -> ProbeResult:
    """Throughput: per-slab loop doing n_y row gathers -> the cost shape of
    one warp channel (no real warp logic, just the ops)."""
    device = resolve_device(device)
    src, idx0 = _on(device, *inputs_d(B, H, W))

    def chain(n):
        carry = torch.zeros((), device=device)
        for _ in range(n):
            out = probes.slab_gather(src, (idx0 + carry.to(torch.int32)).abs(), n_y)
            carry = out.mean()
        return out

    chain(2)
    iters = 50
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        out = chain(iters)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        out = chain(iters)
        ms = (time.perf_counter() - t0) * 1e3 / iters
    print(f"D slab loop n_y={n_y} [{B},{H},{W}]: {ms:.4f} ms/channel "
          f"(x3 ch = {ms * 3:.4f} ms/warp-equivalent)", flush=True)
    return ProbeResult(math.isfinite(ms), out, ms)


def main(argv=None) -> dict:
    """Run the four probes; -> {"A": ProbeResult, ..., "D": ...}. Raises
    if a probe is wrong."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: the card) or cpu (plain versions)")
    device = resolve_device(parser.parse_args(argv).device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"kernel_probe on {name}", flush=True)
    results = {"A": probe_a(device), "B": probe_b(device=device),
               "C": probe_c(device=device), "D": probe_d(device=device)}
    wrong = [k for k, r in results.items() if not r.ok]
    if wrong:
        raise RuntimeError(f"probe(s) {', '.join(wrong)} gave a wrong result")
    return results


if __name__ == "__main__":
    main()
