"""The port's train and eval steps under a process mesh against the
single-process step on the global batch, in float64 on the CPU (gloo):
{data: 2}, {spatial: 2} (warps on halo slabs, K3's plain version) and
{data: 2, spatial: 2} with no halo (every warp takes the exact fallback).
Each run is `python -m monodepth_tpu_torch.parallel.run_steps --spawn
--reference`: its ranks run 2 train steps and 1 eval step from one seeded
init on `make_planar_scenes` batches, and rank 0 then runs the same steps
on one device and reports the differences. In f64 only rounding is left:
loss rel <= 1e-10, per-module gradient rel-L2 <= 1e-9 after the first
step, parameters after 2 Adam steps atol 1e-9, batch-norm running
statistics atol 1e-12, eval loss rel <= 1e-10 (measured: ~1e-14 and
below)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.training.state import MODULES, build_model, module_grads

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ["--height", "32", "--width", "128", "--batch", "4", "--precision", "f32",
          "--train_gt_metrics", "true"]
MESHES = {"data2": (["--data", "2", "--spatial", "1"], []),
          "spatial2": (["--data", "1", "--spatial", "2"], []),
          "data2_spatial2": (["--data", "2", "--spatial", "2"], ["--spatial_halo", "0"])}


def _cmd(mesh, out, timeout, extra=()):
    return [sys.executable, "-m", "monodepth_tpu_torch.parallel.run_steps", *mesh,
            "--device", "cpu", "--spawn", "--reference", "--f64", "--steps", "2",
            "--threads", "1", "--timeout", str(timeout), "--deadline", "600",
            "--out", str(out), *CONFIG, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: [report of each rank]}; the three runs go at once, each rank
    at one intra-op thread. Their 8 ranks take ~50 s on an idle 8-core
    host and over 200 s beside five other test workers, so the deadline,
    a guard against a hung rank, is 600 s."""
    tmp = tmp_path_factory.mktemp("steps")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = {}
    for name, (mesh, extra) in MESHES.items():
        cmd = _cmd(mesh, tmp / name, 60, extra)
        procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=660)
            assert proc.returncode == 0, (name, err[-3000:])
            world = len(list((tmp / name).glob("rank*.json")))
            out[name] = [json.loads((tmp / name / f"rank{r}.json").read_text())
                         for r in range(world)]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_agree(runs, mesh):
    """Every rank reports the mesh it was given, the world size summed on
    the device, and the same losses, metrics and parameters."""
    reports = runs[mesh]
    shape = reports[0]["mesh"]
    assert len(reports) == shape["data"] * shape["spatial"] == reports[0]["world_on_device"]
    for r in reports[1:]:
        for key in ("losses", "train_metrics", "eval", "param_checksum", "grad_norms"):
            assert r[key] == reports[0][key], (mesh, key)


@pytest.mark.parametrize("mesh", MESHES)
def test_train_steps_match_single_device(runs, mesh):
    ref = runs[mesh][0]["reference"]
    assert max(ref["loss_rel"]) <= 1e-10, ref["loss_rel"]
    assert max(ref["grad_rel_l2"].values()) <= 1e-9, ref["grad_rel_l2"]
    assert set(ref["grad_rel_l2"]) == set(MODULES)
    assert ref["param_max_abs"] <= 1e-9
    assert ref["bn_stats_max_abs"] <= 1e-12


@pytest.mark.parametrize("mesh", MESHES)
def test_eval_step_matches_single_device(runs, mesh):
    """The eval loss rel <= 1e-10, and the depth metrics of the gathered
    depths (one median over the global batch) to 1e-10."""
    ref = runs[mesh][0]["reference"]
    assert ref["eval_rel"]["loss"] <= 1e-10
    assert set(ref["eval_rel"]) == {"loss", "abs_rel", "sq_rel", "rmse", "rmse_log",
                                    "a1", "a2", "a3"}
    assert max(ref["eval_rel"].values()) <= 1e-10, ref["eval_rel"]


@pytest.mark.parametrize("mesh", MESHES)
def test_warp_paths(runs, mesh):
    """On the CPU no kernel launches. {data: 2} warps whole images; the
    spatial meshes warp every one of the 24 warps (8 per step, 3 steps) of
    each rank on its slab ({spatial: 2}, halo 16) or, with no halo, in the
    fallback ({data: 2, spatial: 2})."""
    expected = {"data2": (0, 0), "spatial2": (24, 0), "data2_spatial2": (0, 24)}[mesh]
    for r in runs[mesh]:
        assert set(r["launches"].values()) == {0}
        assert (r["slab_warps"], r["fallbacks"]) == expected


def test_module_grads_cover_every_parameter():
    """`module_grads`, which the mesh reports compare, splits every
    parameter's gradient into exactly one of `MODULES`, in f64."""
    model = build_model(Config(height=32, width=64, batch=1), device="cpu")
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, float(i))
    grads = module_grads(model)
    assert tuple(grads) == MODULES
    assert all(g.dtype == torch.float64 for g in grads.values())
    assert sum(g.numel() for g in grads.values()) == sum(
        p.numel() for p in model.parameters())
    assert sum(float(g.sum()) for g in grads.values()) == sum(
        float(p.grad.double().sum()) for p in model.parameters())


def test_reference_runs_after_the_ranks_leave(tmp_path):
    """F8: rank 0's one-device reference takes no collective, and every rank
    leaves the process group before it starts, so no rank waits on a
    collective while it runs. A {data: 2} f64 run whose collectives may wait
    3 s: its reference took 6.6-7.9 s (one thread, on an 8-core host, idle
    or beside a full test run), so a rank still waiting at the final barrier while the
    reference runs times out, as every such run did while rank 0 ran the
    reference before the ranks left the group (rank exit codes [-15, 1])."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run(_cmd(MESHES["data2"][0], tmp_path, 3), cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=660)
    assert done.returncode == 0, done.stderr[-3000:]
    report = json.loads((tmp_path / "rank0.json").read_text())
    assert report["reference_seconds"] > 0
    assert max(report["reference"]["loss_rel"]) <= 1e-10
    assert json.loads((tmp_path / "rank1.json").read_text())["losses"] == report["losses"]
