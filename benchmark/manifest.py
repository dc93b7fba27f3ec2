"""What a cell is, read from `BENCHMARK.json` and the files it names.

A cell names a configuration (`configs/<name>.json`: the port's `Config`
fields as run, with `source`, `reduced` and `assumed`) and a traffic mix
(`traffic/<name>.json`: the parameters its `kind` of driver reads). Its
per-layer metrics are the manifest's entries whose `workloads` list it,
each read by `metrics/<metric name>.py`. The limits of its correctness
check are `limits/<cell name>.json`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the configuration file's keys that are not `Config` fields
CONFIG_NOTES = ("source", "reduced", "assumed")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict             # the configuration file's fields, notes left out
    traffic: dict
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]    # of every metric
    limits: Dict[str, float]


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = manifest(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    return Cell(
        name=name, chips=w["chips"],
        config={k: v for k, v in config.items() if k not in CONFIG_NOTES},
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m["name"] for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m["name"] for m in spec["per_layer"] if _applies(m, name)],
        units={m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]},
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()))


def reader(metric: str) -> Callable:
    """`read` of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(config: dict):
    """The port's `Config` of a configuration's fields."""
    from monodepth_tpu_torch.config import Config

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in config.items()}
    return Config(**fields).validate()
