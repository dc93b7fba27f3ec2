"""The port's mesh train and eval steps with the other pose wirings, in
float64 on the CPU (gloo), against the single-process step on the global
batch, as tests/test_torch_parallel_steps.py holds `separate`: `posecnn`
with the stereo frame (frames 0, -1, 1, "s": PoseCNN's per-scale
transforms, and `stereo_T` split over data) and `shared` with
`pose_frames="all"` (batch norm over B·F images a rank, summed over the
data group), each on {data: 2} and {spatial: 2}. Each run is `python -m
monodepth_tpu_torch.parallel.run_steps --spawn --reference --f64` (2 train
steps and 1 eval step at 32x128, global batch 4; one thread a rank); f64
leaves rounding only: loss rel <= 1e-10, per-module gradient rel-L2 <=
1e-9, parameters atol 1e-9, batch-norm statistics atol 1e-12, eval rel <=
1e-10 (measured ~1e-14 and below)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.parallel.mesh import Mesh, shard_batch
from monodepth_tpu_torch.parallel.run_steps import host_batches
from monodepth_tpu_torch.training.state import build_model
from monodepth_tpu_torch.training.step import apply_and_warp
from torch_parity import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ["--height", "32", "--width", "128", "--batch", "4", "--precision", "f32",
          "--train_gt_metrics", "true"]
WIRINGS = {"posecnn_s": ["--pose_type", "posecnn", "--frame_ids", "0 -1 1 s"],
           "shared_all": ["--pose_type", "shared", "--pose_frames", "all"]}
MESHES = {"data2": ["--data", "2", "--spatial", "1"],
          "spatial2": ["--data", "1", "--spatial", "2"]}
RUNS = [(w, m) for w in WIRINGS for m in MESHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(wiring, mesh): [report of each rank]}; the four runs go at once."""
    tmp = tmp_path_factory.mktemp("wirings")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = {}
    for wiring, mesh in RUNS:
        cmd = [sys.executable, "-m", "monodepth_tpu_torch.parallel.run_steps",
               *MESHES[mesh], "--device", "cpu", "--spawn", "--reference", "--f64",
               "--steps", "2", "--threads", "1", "--timeout", "60", "--deadline", "600",
               "--out", str(tmp / f"{wiring}_{mesh}"), *CONFIG, *WIRINGS[wiring]]
        procs[wiring, mesh] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                               stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, proc in procs.items():
            _, err = proc.communicate(timeout=660)
            assert proc.returncode == 0, f"{key}:\n{err[-3000:]}"
            out[key] = [json.loads((tmp / "_".join(key) / f"rank{r}.json").read_text())
                        for r in range(2)]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("wiring, mesh", RUNS)
def test_ranks_agree(runs, wiring, mesh):
    """Both ranks ran the wiring asked for and report the same losses,
    metrics, gradients and parameters."""
    reports = runs[wiring, mesh]
    want = {"posecnn_s": ("posecnn", ["0", "-1", "1", "s"], 2),
            "shared_all": ("shared", ["0", "-1", "1"], "all")}[wiring]
    for r in reports:
        assert (r["pose_type"], r["frame_ids"], r["pose_frames"]) == want
        assert r["backend"] == "gloo" and r["world_on_device"] == 2.0
        for key in ("losses", "train_metrics", "eval", "param_checksum", "grad_norms"):
            assert r[key] == reports[0][key], key


@pytest.mark.parametrize("wiring, mesh", RUNS)
def test_train_steps_match_single_device(runs, wiring, mesh):
    ref = runs[wiring, mesh][0]["reference"]
    modules = {"posecnn_s": {"encoder", "decoder", "pose_decoder"},
               "shared_all": {"encoder", "decoder", "pose_decoder"}}[wiring]
    assert set(ref["grad_rel_l2"]) == modules
    assert max(ref["loss_rel"]) <= 1e-10, ref["loss_rel"]
    assert max(ref["grad_rel_l2"].values()) <= 1e-9, ref["grad_rel_l2"]
    assert ref["param_max_abs"] <= 1e-9
    assert ref["bn_stats_max_abs"] <= 1e-12


@pytest.mark.parametrize("wiring, mesh", RUNS)
def test_eval_step_matches_single_device(runs, wiring, mesh):
    ref = runs[wiring, mesh][0]["reference"]
    assert set(ref["eval_rel"]) == {"loss", "abs_rel", "sq_rel", "rmse", "rmse_log",
                                    "a1", "a2", "a3"}
    assert max(ref["eval_rel"].values()) <= 1e-10, ref["eval_rel"]


@pytest.mark.parametrize("wiring, mesh", RUNS)
def test_warp_paths(runs, wiring, mesh):
    """No kernel launches on the CPU. {spatial: 2} warps every warp of 3
    steps on its slab (12 a step with "s", 8 without); {data: 2} warps
    whole images."""
    warps = 3 * (12 if wiring == "posecnn_s" else 8)
    for r in runs[wiring, mesh]:
        assert set(r["launches"].values()) == {0}
        assert (r["slab_warps"], r["fallbacks"]) == ((warps, 0) if mesh == "spatial2"
                                                     else (0, 0))


def test_stereo_transform_splits_over_data():
    """`shard_batch` cuts `stereo_T` over the data axis, in rank order, and
    gives it whole to every spatial rank; `host_batches` fills it with the
    scenes' baselines."""
    cfg = Config(height=32, width=128, batch=4, frame_ids=(0, -1, 1, "s"))
    batch = host_batches(cfg, 1, np.float64)[0]
    assert batch["frames"].shape[1] == 4 and batch["stereo_T"].shape == (4, 4, 4)
    np.testing.assert_array_equal(batch["frames"][:, 3], batch["frames"][:, 2])
    assert (batch["stereo_T"][:, 0, 3] != 0).all()
    pieces = [shard_batch(Mesh(2, 1, r, torch.device("cpu")), batch)["stereo_T"]
              for r in range(2)]
    assert torch.equal(torch.cat(pieces), torch.from_numpy(batch["stereo_T"]))
    for r in range(2):
        piece = shard_batch(Mesh(1, 2, r, torch.device("cpu")), batch)["stereo_T"]
        assert torch.equal(piece, torch.from_numpy(batch["stereo_T"]))


def test_posecnn_translation_scale_is_per_image():
    """PoseCNN scales each translation by its own image's mean inverse
    depth (`training/step.py`), so a rank's transforms need no collective:
    in eval mode (batch norm from running statistics, no batch coupling)
    the first two images warp the same in a batch of 4 as alone (f64)."""
    cfg = Config(height=32, width=128, batch=4, pose_type="posecnn",
                 frame_ids=(0, -1, 1, "s"), precision="f32", use_pallas=False)
    model = build_model(cfg, device="cpu").double()
    batch = {k: torch.from_numpy(v) for k, v in host_batches(cfg, 1, np.float64)[0].items()
             if k != "depth_gt"}
    with torch.no_grad():
        whole = apply_and_warp(model, batch, cfg)
        half = apply_and_warp(model, {k: v[:2] for k, v in batch.items()}, cfg)
    for scale in cfg.scales:
        for a, b in zip(whole["warped"][scale], half["warped"][scale]):
            torch.testing.assert_close(a[:2], b, rtol=1e-12, atol=1e-12)
