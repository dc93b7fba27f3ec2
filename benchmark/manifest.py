"""What a cell is, read from `BENCHMARK.json` and the files it names.

A cell names a configuration (`configs/<name>.json`: its model family's
fields as run, with the notes `source`, `reduced`, `assumed` and
`family`, which names `families/<family>.py`, `monodepth2` where it is
left out) and a traffic mix (`traffic/<name>.json`: the parameters that
the driver `<kind>.py` of its `kind` reads). Its per-layer metrics are
the manifest's entries whose `workloads` list it, each read by
`metrics/<metric name>.py`. The limits of its correctness check are
`limits/<cell name>.json`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

from benchmark import families

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the configuration file's keys that are not the family's fields
CONFIG_NOTES = ("source", "reduced", "assumed", "family")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    family: str              # the configuration's model family
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
        name=name, chips=w["chips"], family=config.get("family", families.DEFAULT),
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


def driver(kind: str) -> ModuleType:
    """The driver of a traffic `kind`: the module `<kind>.py` beside this
    one, which defines `run`."""
    path = HERE / f"{kind}.py"
    module = None
    if kind.isidentifier() and path.is_file():
        module = importlib.import_module(f"{__package__}.{kind}")
    if not callable(getattr(module, "run", None)):
        raise ValueError(f"traffic kind {kind!r}: no driver file {path} defining run")
    return module
