"""One run of one benchmark cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result, one JSON object: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (read from
a traced window after the measured one) and the trace's breakdown. The
numbers of the correctness check, each beside its limit, are the last
lines of standard error and the result's last key. Without enough CUDA
devices, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits with 2.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "monodepth_tpu")


def process_start() -> float:
    """The wall-clock time this process started (from /proc), else the
    time this module was first run."""
    try:
        ticks = float(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in open("/proc/stat")
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's, Optax's or
    the JAX package's, compared whole (the port's name begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(torch) -> dict:
    import subprocess
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        line = ""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "power_limit": line.split(",")[-1].strip() if line else None}


def peaks(kind: str) -> dict:
    """The card's published peaks (`peaks.json`), {} for a card not listed."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return next((v for k, v in table.items() if k in kind), {})


def per_layer(cell, out: dict, kind: str) -> dict:
    """{metric: value} of each per-layer metric whose reader finds
    something to read in this run."""
    from benchmark.manifest import reader

    context = dict(out, chips=cell.chips, peaks=peaks(kind))
    values = {}
    for name in cell.per_layer:
        value = reader(name)(context)
        if value is not None:
            values[name] = value
    return values


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float, **hooks):
    """Drive the cell's traffic and check it -> (result dict, check report).
    On several cards rank 0 runs here and the others in processes of their
    own. The CPU tests call this at a small size, with `fault=` breaking
    the step underneath."""
    import torch

    from benchmark import check, manifest, ranks

    driver = manifest.driver(cell.traffic["kind"])
    procs = ranks.spawn(cell.chips, driver.run, cell, seed, seconds, trace, device, t0,
                        **hooks) if cell.chips > 1 else []
    try:
        out = driver.run(cell, seed, seconds, trace, device, t0, **hooks)
    except BaseException:
        ranks.stop(procs)
        raise
    ranks.join(procs)
    correct, failed, report = check.verdict(out["checks"], cell.limits)
    if trace:
        kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        metrics = per_layer(cell, out, kind)
    else:
        metrics = {k: v for k, v in out["metrics"].items() if k in cell.end_to_end}
    result = {"correct": correct, "attempted": out["attempted"], "failed": failed,
              "metrics": {k: {"value": v, "unit": cell.units[k]} for k, v in metrics.items()},
              "device": {"count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        result["device"].update(busy_s=out["busy_s"], window_s=out["trace"].window_s)
        result["breakdown"] = out["trace"].breakdown()
    return result, report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import check
    from benchmark.manifest import cell as load_cell

    # one process, one host thread of its own for the host's share of the
    # work: other threads would only contend with it for the cores
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result, report = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), process_start())
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 2
    result["device"] = dict(card(torch), **result["device"])
    result["checks"] = report
    check.print_report(report)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
