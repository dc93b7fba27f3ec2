"""The port's Eigen sweep over several processes (`process_slice`,
`evaluate_multihost`, the multi-process `model_test`) against the JAX
package's and against one process, on one synthetic KITTI tree (a 7-line
test split) and one set of weights (a seeded port model carried into the
JAX tree with `torch_parity.flax_variables`, written as the JAX package's
npz exports). ResNet-18, 64x96, scales (0, 1), f32 unless said; one JAX
infer compile. The 2-rank runs are gloo on the CPU under torchrun (one
intra-op thread a rank, 60 s collective timeout, 600 s deadline).

- `process_slice` equals JAX's for every (index, count) of the split;
- `evaluate_multihost` in one process equals JAX's at rtol 1e-4;
- on 2 ranks it equals one process at rtol 1e-6 (the same per-image
  errors, summed in another order);
- a rank that fails (before the call, or inside its sweep) makes both
  ranks raise, naming it, and neither hangs;
- the 2-rank `model_test --save_pred_disps` file equals the one-process
  file (rtol 1e-6: each image's disparity does not depend on its
  batch-mates), and rank 0 prints the one-process table."""

import contextlib
import io
import json
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.evaluation import eigen as jeigen
from monodepth_tpu.training.state import TrainState as JTrainState
from monodepth_tpu.utils import serialization as jserialization
from monodepth_tpu_torch import model_test
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.data.synthetic import DRIVE, make_kitti_tree
from monodepth_tpu_torch.evaluation import eigen
from monodepth_tpu_torch.training.state import MODULES, build_model
from torch_parity import flax_variables, one_thread, randomize_bn_stats

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(height=64, width=96, scales=(0, 1), num_layers=18, precision="f32",
          weight_init=False)
EPOCH = 2
LINES = [f"{DRIVE} {i} {'lr'[i % 2]}" for i in range(1, 8)]


def _torchrun(*args):
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", *args]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def _wait(proc, what):
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{what}: past the 600 s deadline\n{err[-3000:]}")
    assert proc.returncode == 0, f"{what}:\n{err[-3000:]}"
    return out


def _cli_args(datapath, splits, weights, out):
    return ["--datapath", datapath, "--splits", splits, "--height", "64", "--width", "96",
            "--eval_batch", "2", "--weights", f"{weights}:{EPOCH}",
            "--save_pred_disps", out, "--gt_cache", "", "--device", "cpu"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(cfg, the port model, its JAX variables, weights dir, splits dir,
    work dir)."""
    base = tmp_path_factory.mktemp("eigen_mesh")
    root = make_kitti_tree(str(base / "kitti"), num_frames=9, seed=4, image_hw=(96, 320))
    splits = base / "splits"
    os.makedirs(splits / "kitti_eigen_zhou")
    kitti.savelines(LINES, str(splits / "kitti_eigen_zhou" / "test_files.txt"))
    cfg = Config(datapath=root, splits=str(splits), **KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=6)
    variables = flax_variables(model.state_dict(), cfg)
    weights = base / "weights"
    os.makedirs(weights)
    for name in MODULES:
        tree = {"params": variables["params"][name]}
        if name in variables["batch_stats"]:
            tree["batch_stats"] = variables["batch_stats"][name]
        jserialization.save_npz(str(weights / f"{name}{EPOCH}.npz"), tree)
    return cfg, model, variables, str(weights), str(splits), base


@pytest.fixture(scope="module")
def mesh_runs(setup):
    """The 2-rank worker and the 2-rank `model_test` (started together),
    and the one-process `model_test` in this process meanwhile ->
    (rank reports, 2-rank CLI stdout, 2-rank disparities, one-process
    stdout, one-process disparities)."""
    cfg, _, _, weights, splits, base = setup
    worker = _torchrun(str(ROOT / "tests" / "torch_eigen_worker.py"), str(base / "out"),
                       cfg.datapath, splits, weights, str(EPOCH))
    cli = _torchrun("-m", "monodepth_tpu_torch.model_test",
                    *_cli_args(cfg.datapath, splits, weights, str(base / "two.npy")))
    try:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            model_test.main(_cli_args(cfg.datapath, splits, weights, str(base / "one.npy")))
        _wait(worker, "worker")
        two_text = _wait(cli, "model_test")
    finally:
        for proc in (worker, cli):
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    reports = [json.loads((base / "out" / f"rank{r}.json").read_text()) for r in range(2)]
    return (reports, two_text, np.load(base / "two.npy"), text.getvalue(),
            np.load(base / "one.npy"))


@pytest.mark.parametrize("count", range(1, 8))
def test_process_slice_equals_jax(count, monkeypatch):
    for index in range(count):
        monkeypatch.setattr(jax, "process_index", lambda: index)
        monkeypatch.setattr(jax, "process_count", lambda: count)
        assert eigen.process_slice(LINES, index, count) == jeigen.process_slice(LINES)
    assert eigen.process_slice(LINES) == LINES  # no process group: everything
    with pytest.raises(ValueError, match="together"):
        eigen.process_slice(LINES, index=0)


def test_evaluate_multihost_one_process_matches_jax(setup, monkeypatch):
    """Both packages' `evaluate_multihost` in one process (JAX on one local
    device) on the same weights: the metrics at rtol 1e-4."""
    cfg, model, variables, *_ = setup
    jstate = JTrainState(step=jnp.int32(0), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=None,
                         rng=jax.random.PRNGKey(0))
    devices = jax.local_devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda: devices)
    gts = eigen.load_ground_truth(cfg.datapath, LINES)
    theirs = jeigen.evaluate_multihost(JConfig(datapath=cfg.datapath, **KW), jstate, LINES,
                                       gts, eval_batch=2, num_workers=1)
    ours = eigen.evaluate_multihost(cfg, model, LINES, gts, eval_batch=2, num_workers=1)
    assert list(ours) == list(theirs)
    np.testing.assert_allclose(list(ours.values()), list(theirs.values()), rtol=1e-4)
    # the same sums as the sweep's table
    table = eigen.eigen_metrics(eigen.predict_disparities(cfg, model, LINES, 2, 1,
                                                          device="cpu"), gts)
    np.testing.assert_allclose(list(ours.values()), list(table.values()), rtol=1e-12)


def test_two_processes_equal_one(setup, mesh_runs):
    """Each rank sweeps the interleaved lines[r::2]; both end with the same
    metrics, those of one process sweeping the split (rtol 1e-6)."""
    cfg, model, *_ = setup
    reports = mesh_runs[0]
    assert [r["lines"] for r in reports] == [LINES[0::2], LINES[1::2]]
    assert reports[0]["metrics"] == reports[1]["metrics"]
    one = eigen.evaluate_multihost(cfg, model, LINES,
                                   eigen.load_ground_truth(cfg.datapath, LINES),
                                   eval_batch=2, num_workers=1)
    assert list(reports[0]["metrics"]) == list(one)
    np.testing.assert_allclose(list(reports[0]["metrics"].values()), list(one.values()),
                               rtol=1e-6)


@pytest.mark.parametrize("case, failed", [("failure", 1), ("inside", 0)])
def test_a_failed_rank_makes_every_rank_raise(mesh_runs, case, failed):
    """Rank 1 passing `failure`, or rank 0's sweep failing (one ground
    truth short): both ranks reach the all-gather and raise, naming the
    failed rank, and the run ends (no rank waits in a collective)."""
    for report in mesh_runs[0]:
        message = report["raised"][case]
        assert message is not None and f"failed on process(es) [{failed}]" in message
        own = report["rank"] == failed
        assert ("this rank succeeded" in message) != own, message


def test_two_process_model_test_saves_the_one_process_file(mesh_runs):
    """`model_test` under torchrun on 2 ranks: rank 0 writes the
    disparities back in the split's order, equal to the one-process file,
    and prints the one-process table."""
    _, two_text, two, one_text, one = mesh_runs
    assert two.shape == one.shape == (7, 64, 96) and two.dtype == np.float32
    np.testing.assert_allclose(two, one, rtol=1e-6)
    assert ">>> eval processes: 2 (gloo)" in two_text
    strip = [line for line in two_text.splitlines() if "eval processes" not in line]
    assert [line.split(" to ")[0] for line in strip] == \
        [line.split(" to ")[0] for line in one_text.splitlines()]
    assert two_text.count("abs_rel") == 1
