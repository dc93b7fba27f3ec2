"""`BENCHMARK.json` and the files it names: the allowed names, units
and limits, every cell's metrics, the files a later change adds a cell
by, and a run in a process where JAX and the JAX package cannot load."""

import ast
import json
import math
import re
import subprocess
import sys

import pytest

from benchmark import families, run
from benchmark.manifest import CONFIG_NOTES, HERE, ROOT, cell, driver, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = manifest()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert SPEC["paths"] == ["benchmark"]
    script = [w for w in SPEC["command"] if w.endswith(".py")]
    assert script and all((ROOT / w).is_file() and w.startswith("benchmark/") for w in script)
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    checks = 2 + 14 * 24
    assert checks * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len({n for n in names}) == len(names)
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)


def test_every_cell_reports_what_its_metrics_move():
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for name in CELLS:
        c = cell(name)
        assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
        for m in SPEC["per_layer"]:
            if name in m.get("workloads", CELLS):
                assert m["moves"] in c.end_to_end, (name, m["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))


def test_every_entry_has_its_files():
    """A configuration, traffic mix, cell or per-layer metric is files
    found by its name: adding one edits no file that is there. A
    configuration's fields are its family's, and a traffic mix's `kind`
    names a driver file that defines `run`."""
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path == HERE / "configs" / f"{c['name']}.json"
        conf = json.loads(path.read_text())
        family = families.load(conf.get("family", families.DEFAULT))
        family.config({k: v for k, v in conf.items() if k not in CONFIG_NOTES})
        assert set(c["reduced"]) == set(conf["reduced"]) <= set(conf) - set(CONFIG_NOTES)
        assert len(conf["source"]) <= 200
    for w in SPEC["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        kind = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        assert (HERE / f"{kind}.py").is_file() and callable(driver(kind).run)
    for m in SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("name,what", [("nothing_such", "driver"), ("check", "driver"),
                                       ("nothing_such", "family"), ("../run", "family")])
def test_an_unknown_kind_or_family_names_the_file_it_looked_for(name, what):
    look = driver if what == "driver" else families.load
    folder = HERE if what == "driver" else HERE / "families"
    with pytest.raises(ValueError, match=re.escape(str(folder / f"{name}.py"))):
        look(name)


def test_a_rank_that_loaded_jax_fails(monkeypatch):
    """Ranks 1..n-1 check their own modules after their run: `join` then
    raises and rank 0 prints no result."""
    import torch

    from benchmark import ranks

    monkeypatch.setattr(ranks, "environment", lambda rank, world, port: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    ranks._rank(1, 2, 0, lambda: None, (), {})
    with pytest.raises(SystemExit) as stop:
        ranks._rank(1, 2, 0, lambda: sys.modules.setdefault("jaxlib", object()), (), {})
    monkeypatch.delitem(sys.modules, "jaxlib")
    assert stop.value.code != 0


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "monodepth_tpu_torch", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "monodepth_tpu.ops", object())
    assert run.forbidden_modules() == ["monodepth_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    """Nor does any family's reference, nor the harness's inputs and
    checks."""
    paths = {HERE / f"{name}.py" for name in ("reference", "scenes", "weights", "counts",
                                              "check")}
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        paths.add(families.load(conf.get("family", families.DEFAULT)).reference.__file__)
    for path in paths:
        tree = ast.parse(open(path).read())
        imported = {a.name.split(".")[0] for node in ast.walk(tree)
                    if isinstance(node, ast.Import) for a in node.names}
        imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                     if isinstance(node, ast.ImportFrom) and node.module}
        assert not imported & {"monodepth_tpu_torch", "jax", "flax", "optax", "monodepth_tpu"}


BLOCKED_RUN = r"""
import importlib.abc, sys, time
BLOCK = {"jax", "jaxlib", "flax", "optax", "monodepth_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1]]
import dataclasses, torch
torch.set_num_threads(2)
from benchmark import calibrate, run
from benchmark.manifest import cell
for name in sys.argv[2:]:
    c = cell(name)
    c = dataclasses.replace(c, config=dict(c.config, height=64, width=96, batch=2),
                            traffic=dict(c.traffic, batch=2, ring=3))
    result, _ = run.run_cell(c, 1, 0.2, False, torch.device("cpu"), time.time())
    assert result["attempted"] > 0
assert run.forbidden_modules() == [], run.forbidden_modules()
print("ok")
"""


def test_a_run_with_jax_blocked():
    kinds = {}
    for w in SPEC["workloads"]:
        kinds.setdefault(json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
                         ["kind"], w["name"])
    done = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(ROOT), *kinds.values()],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0 and done.stdout.strip().endswith("ok"), done.stderr[-3000:]


def test_no_result_without_a_card():
    done = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and not done.stdout.strip()
