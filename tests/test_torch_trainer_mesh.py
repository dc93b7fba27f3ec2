"""The port's Trainer and train CLI on a process mesh: 2 gloo processes on
the CPU (torch only), against the one-process Trainer on the same global
batches. A synthetic KITTI tree at 64x96, ResNet-18, scales (0, 1), global
batch 4 (2 a rank), 2 epochs of 2 train steps and 1 validation step, f32,
the kernels' plain versions (`use_pallas`). The ranks start under torchrun
(`python -m torch.distributed.run --standalone`, one intra-op thread a
rank) with a 60 s collective timeout and a 600 s deadline for the run.

- every rank's `Loader` slice, together, is the one-process batch, bit for
  bit, also after `prefetch_to_device`;
- the mesh's losses equal the one-process Trainer's: the first step's
  within rtol 1e-5 (the same parameters and batch: the convolutions round
  at another batch size, batch norm sums in another order, and its
  variance is E[x²] - E[x]², flax's form, where one process takes
  torch's); every step's, and the epoch records, within rtol 3e-4
  (measured 6.8e-5; the threshold fractions a1-a3 atol 1e-3, a pixel's
  worth 2.5e-4). In f32 that rounding moves the first gradients by
  0.2-0.6% rel-L2 (`run_steps` f32 {data: 2} at 64x96; 1e-14 in f64; a
  two-pass variance on the mesh leaves it so, so near-ties of the loss's
  per-pixel minimum are the suspect), and Adam's first updates,
  lr·sign(g) where |g| is small, carry it on: each module's update of 4
  steps (export minus init) lies within 0.2 rel-L2 of the one process's
  (measured 0.017-0.060; half the learning rate would read 0.5), the
  batch-norm statistics within 2e-3 rel-L2 (5.5e-4);
- 1 epoch and a `--resume` through `model_train` under torchrun equal 2
  epochs straight (with `--async_ckpt`): state, Adam and records bit for
  bit;
- rank 0 alone writes states, exports, records and curves;
- SIGTERM on rank 1 stops both ranks after the same epoch, with its
  checkpoint;
- a `--data_parallel` the world does not fit raises;
- the body a captured `{data: 2}` train step captures, run eagerly on the
  noise drawn ahead for the global batch and cut to the rank's items,
  equals the eager mesh step bit for bit (losses and state, 2 steps), on
  the "mesh" run's ranks before their Trainer starts."""

import dataclasses
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.dataset import KittiDataset
from monodepth_tpu_torch.data.kitti import readlines, savelines
from monodepth_tpu_torch.data.pipeline import Loader, prefetch_to_device
from monodepth_tpu_torch.data.synthetic import make_kitti_tree, make_split_files
from monodepth_tpu_torch.training import Trainer
from monodepth_tpu_torch.training.state import build_model
from monodepth_tpu_torch.utils.jax_export import jax_variables
from monodepth_tpu_torch.utils.serialization import load_npz
from torch_parity import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = ("encoder", "decoder", "pose_encoder", "pose_decoder")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree: 8 train lines (2 steps of 4 an epoch), 4
    validation lines (1 step)."""
    root = str(tmp_path_factory.mktemp("kitti"))
    make_kitti_tree(root, num_frames=8, image_hw=(96, 320))
    splits = make_split_files(root, num_frames=8)
    lines = readlines(os.path.join(splits, "kitti_eigen_zhou", "train_files.txt"))
    savelines(lines[:8], os.path.join(splits, "kitti_eigen_zhou", "train_files.txt"))
    savelines(lines[:4], os.path.join(splits, "kitti_eigen_zhou", "val_files.txt"))
    return root, splits


def _flags(tree, save_root, save, epoch, *extra):
    root, splits = tree
    return ["--datapath", root, "--splits", splits, "--height", "64", "--width", "96",
            "--scales", "0 1", "--batch", "4", "--epoch", str(epoch), "--num_workers", "2",
            "--precision", "f32", "--weight_init", "false", "--save_root", str(save_root),
            "--save", save, "--log_every", "0", "--ckpt_every", "1", *extra]


def _torchrun(*args):
    """Two ranks under torchrun, in a session of their own so that a stuck
    run can be killed whole."""
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


def _reports(out_dir):
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory, request):
    """The mesh runs, the first three at once, beside the one-process
    Trainer in this process:
    - "mesh": the worker, 2 epochs straight, async checkpoints;
    - "split": `model_train` for 1 epoch, then `--resume` to 2;
    - "stop": the worker, 3 epochs, rank 1 signalled in the first;
    - "one": the one-process Trainer, 2 epochs, per-step losses, its
      state and exports written after the second epoch only (the tests
      read those exports, and no state of it).
    The runs' states (~0.3 GB each) and exports go when the module's
    tests end."""
    base = tmp_path_factory.mktemp("mesh")
    request.addfinalizer(lambda: shutil.rmtree(base, ignore_errors=True))
    worker = str(ROOT / "tests" / "torch_trainer_worker.py")
    procs = {
        "mesh": _torchrun(worker, str(base / "mesh_out"), "--graph_body",
                          *_flags(tree, base, "mesh", 2, "--async_ckpt", "true")),
        "split": _torchrun("-m", "monodepth_tpu_torch.model_train", "--device", "cpu",
                           *_flags(tree, base, "split", 1)),
        "stop": _torchrun(worker, str(base / "stop_out"), "--stop_rank", "1",
                          *_flags(tree, base, "stop", 3, "--ckpt_every", "5")),
    }
    try:
        cfg = Config(**{**_cfg_fields(tree, base), "save": "one", "ckpt_every": 2})
        one = Trainer(cfg, device="cpu")
        losses, step = [], one.train_step
        one.train_step = lambda state, batch: \
            losses.append(float((m := step(state, batch))["loss"])) or m
        one.train()
        out = {name: _wait(proc, name) for name, proc in procs.items()}
        out["resume"] = _wait(_torchrun(
            "-m", "monodepth_tpu_torch.model_train", "--device", "cpu",
            *_flags(tree, base, "split", 2, "--resume", "true")), "resume")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return {"base": base, "stdout": out, "one_losses": losses, "one": one,
            "mesh": _reports(base / "mesh_out"), "stop": _reports(base / "stop_out")}


def _cfg_fields(tree, base):
    root, splits = tree
    return dict(datapath=root, splits=splits, height=64, width=96, scales=(0, 1),
                batch=4, epoch=2, num_workers=2, precision="f32", weight_init=False,
                save_root=str(base), log_every=0, ckpt_every=1)


def _records(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _untimed(record):
    record = {k: v for k, v in record.items() if k != "time"}
    for split in ("train", "valid"):
        record[split] = {k: v for k, v in record[split].items() if k != "img_per_sec"}
    return record


@pytest.mark.parametrize("training", [True, False])
def test_rank_slices_tile_the_one_process_batch(tree, training):
    """Each rank's `Loader` loads its contiguous half of every global batch;
    the halves in rank order are the one-process batch bit for bit, and
    `prefetch_to_device` hands them on unchanged."""
    root, splits = tree
    name = "train_files.txt" if training else "val_files.txt"
    dataset = KittiDataset(root, readlines(os.path.join(splits, "kitti_eigen_zhou", name)),
                           is_training=training, frame_ids=(0, -1, 1), height=64, width=96)

    def batches(index, count):
        loader = Loader(dataset, 4, shuffle=training, num_workers=2, seed=3,
                        process_index=index, process_count=count)
        try:
            return list(prefetch_to_device(loader.epoch(1), 2, "cpu"))
        finally:
            loader.close()

    whole, halves = batches(0, 1), [batches(r, 2) for r in range(2)]
    assert len(whole) == len(halves[0]) == len(halves[1]) > 0
    for i, batch in enumerate(whole):
        assert halves[0][i]["frames"].shape[0] == 2
        for key, value in batch.items():
            assert torch.equal(torch.cat([halves[0][i][key], halves[1][i][key]]), value), key


def test_mesh_losses_match_one_process(runs):
    """Both ranks log the same global loss at every step (a mean over the
    ranks), which equals the one-process Trainer's within rtol 1e-5."""
    ranks, one = runs["mesh"], runs["one_losses"]
    assert len(one) == 4 and ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["local_batch"] == 2 and ranks[0]["step"] == 4
    np.testing.assert_allclose(ranks[0]["losses"][0], one[0], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["losses"], one, rtol=3e-4)
    mesh = _records(runs["base"] / "mesh")
    ours = _records(runs["one"].save_dir)
    assert len(mesh) == len(ours) == 2
    # warp_span is telemetry: on a mesh the max over the ranks of each
    # rank's mean (at least the global mean, `training/step.py` `_metrics`)
    for a, b in zip(mesh, ours):
        assert a["train"]["warp_span"] >= b["train"]["warp_span"] * (1 - 1e-6)
        for split in ("train", "valid"):
            keys = [k for k in b[split] if b[split][k] is not None
                    and k != "img_per_sec" and not k.startswith("warp_span")]
            for k in keys:
                # a1-a3 count pixels under a threshold: a pixel that crosses
                # it moves them by 1 / valid pixels (2.5e-4 here)
                atol = 1e-3 if k in ("a1", "a2", "a3") else 0.0
                np.testing.assert_allclose(a[split][k], b[split][k], rtol=3e-4,
                                           atol=atol, err_msg=f"{split} {k}")


def _flat(tree) -> np.ndarray:
    leaves = []

    def walk(node):
        for key in sorted(node):
            walk(node[key]) if isinstance(node[key], dict) else \
                leaves.append(np.asarray(node[key], np.float64).ravel())

    walk(tree)
    return np.concatenate(leaves)


def test_mesh_exports_match_one_process(runs):
    """The epoch-2 module exports of the mesh and of one process: each
    module's update from the seeded init within 0.2 rel-L2, its batch-norm
    statistics within 2e-3 rel-L2 (module docstring)."""
    init = jax_variables(build_model(runs["one"].cfg, device="cpu").state_dict(), 18,
                         (0, 1))
    for module in MODULES:
        ours = load_npz(str(runs["base"] / "mesh" / f"{module}2.npz"))
        theirs = load_npz(os.path.join(runs["one"].save_dir, f"{module}2.npz"))
        start = _flat(init["params"][module])
        update, want = _flat(ours["params"]) - start, _flat(theirs["params"]) - start
        assert np.linalg.norm(want) > 0
        assert np.linalg.norm(update - want) <= 0.2 * np.linalg.norm(want), module
        assert ("batch_stats" in ours) == ("batch_stats" in theirs)
        if "batch_stats" in ours:
            a, b = _flat(ours["batch_stats"]), _flat(theirs["batch_stats"])
            assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b), module


def test_mesh_resume_equals_straight_run(runs):
    """`model_train` under torchrun: 1 epoch, then `--resume true` to the
    second, equals the worker's 2 straight epochs: the state file of epoch
    2 (model, Adam, step, seed) bit for bit, and the records but their
    times."""
    assert ">>> devices: 2 (mesh {'data': 2, 'spatial': 1}; cpu, gloo)" in \
        runs["stdout"]["split"]
    assert ">>> resumed from epoch 0" in runs["stdout"]["resume"]
    straight = torch.load(runs["base"] / "mesh" / "state_0001.pt", weights_only=True)
    resumed = torch.load(runs["base"] / "split" / "state_0001.pt", weights_only=True)
    assert straight["step"] == resumed["step"] == 4
    assert (straight["seed"], straight["epoch"]) == (resumed["seed"], resumed["epoch"])
    for key, value in straight["model"].items():
        assert torch.equal(value, resumed["model"][key]), key
    sa, sb = straight["optimizer"]["state"], resumed["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key, value in sa[i].items():
            assert torch.equal(value, sb[i][key]), (i, key)
    assert [_untimed(r) for r in _records(runs["base"] / "mesh")] == \
        [_untimed(r) for r in _records(runs["base"] / "split")]


def test_only_rank_zero_writes(runs):
    """Rank 0 writes 2 states (one an epoch), 2 x 4 module exports, 2
    records and the curves once; rank 1 writes nothing. The files hold
    each epoch once."""
    ranks = runs["mesh"]
    assert ranks[0]["writes"] == {"state": 2, "export": 8, "record": 2, "curves": 1}
    assert ranks[1]["writes"] == {"state": 0, "export": 0, "record": 0, "curves": 0}
    save = runs["base"] / "mesh"
    assert [r["epoch"] for r in _records(save)] == [0, 1]
    assert np.load(save / "loss" / "train_loss.npy").shape == (2,)
    assert {f"{m}{e}.npz" for m in MODULES for e in (1, 2)} | \
        {"state_0000.pt", "state_0001.pt"} <= set(os.listdir(save))


def test_stop_flag_on_one_rank_stops_both(runs):
    """SIGTERM reaches rank 1 alone in the first epoch (of 3, checkpoints
    every 5): both ranks checkpoint and stop after that epoch, and neither
    waits in a collective of the next."""
    for report in runs["stop"]:
        assert report["epochs"] == [0] and report["step"] == 2, report
    save = runs["base"] / "stop"
    assert [r["epoch"] for r in _records(save)] == [0]
    assert {"state_0000.pt", "encoder1.npz"} <= set(os.listdir(save))
    assert "state_0001.pt" not in os.listdir(save)


def test_data_parallel_must_cover_the_world(tree, tmp_path, runs):
    """`--data_parallel` is 0 or the world size: 3 raises on 2 ranks, and
    2 raises in one process."""
    for report in runs["mesh"]:
        assert report["misfit"].startswith("--data_parallel 3: the Trainer's mesh covers")
    cfg = Config(**{**_cfg_fields(tree, tmp_path), "data_parallel": 2})
    with pytest.raises(ValueError, match="covers every process of the group"):
        Trainer(dataclasses.replace(cfg), device="cpu")


RESTORE_SCRIPT = """
import datetime, os, sys
import torch, torch.distributed as dist
from monodepth_tpu_torch.training.checkpoint import Checkpointer
dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
rank = dist.get_rank()
directory = os.path.join(sys.argv[1], f"rank{rank}")
if rank == 0:
    os.makedirs(directory)
    torch.save({"epoch": 3}, os.path.join(directory, "state_0003.pt"))
ckpt = Checkpointer(directory)
print(f"rank {rank} latest {ckpt.latest_epoch()}", flush=True)
try:
    ckpt.restore(None)
except RuntimeError as exc:
    print(f"rank {rank} raised: {exc}", flush=True)
dist.destroy_process_group()
"""


def test_resume_follows_rank_zero_and_a_failed_read_raises_everywhere(tmp_path):
    """The ranks see different directories: rank 0 holds epoch 3, rank 1
    nothing. Both take rank 0's latest epoch (so both enter `restore`),
    rank 1 cannot read the file, and both raise naming rank 1 instead of
    rank 0 waiting in the next collective."""
    script = tmp_path / "restore.py"
    script.write_text(RESTORE_SCRIPT)
    out = _wait(_torchrun(str(script), str(tmp_path)), "restore")
    for rank in (0, 1):
        assert f"rank {rank} latest 3" in out, out
        assert f"rank {rank} raised: restore of epoch 3 failed on rank(s) {{1: " in out, out


def test_captured_mesh_body_equals_the_eager_mesh_step(runs):
    """What a captured `{data: 2}` train step replays, run eagerly with the
    noise drawn ahead (each rank 2 of the global 4 items a scale), gives
    the eager mesh step's losses and state (parameters, buffers, Adam) bit
    for bit, on both ranks; the eager step is held to JAX's mesh step by
    `test_torch_parallel_steps.py` and `test_torch_wirings_mesh.py`."""
    ranks = runs["mesh"]
    for r in ranks:
        body = r["graph_body"]
        assert body["body_losses"] == body["eager_losses"], r["rank"]
        assert body["state_max_abs_diff"] == 0.0, r["rank"]
        assert body["steps"] == [2, 2]
        assert body["noise_items"] == [[2, 2], [2, 2]]  # scales 0 and 1
    assert ranks[0]["graph_body"]["eager_losses"] == ranks[1]["graph_body"]["eager_losses"]
