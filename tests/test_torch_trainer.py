"""The port's Trainer, checkpoints and train CLI on the CPU (torch only):
a synthetic KITTI tree at 32x64, scales (0, 1), batch 2, f32, the
kernels' plain versions (`use_pallas`).

- 2 epochs equal 1 epoch and a resume, bit for bit: parameters,
  batch-norm buffers, Adam's state, step, the metrics.jsonl records (but
  their times) and the curves;
- `Checkpointer`: round trip, `keep` pruning with the module exports, an
  async save that snapshots before it returns;
- `_Meter`, `load_pretrained` (.pth, .npz, no file), `--steps_per_call`,
  the SIGTERM checkpoint, `--data_parallel` above the one process;
- `python -m monodepth_tpu_torch.model_train --device cpu` trains,
  checkpoints and exports, and `model_test` scores the export;
- the convergence proof tool at a tiny size;
- `tools/plot_curves.py` on a Trainer run's curves."""

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.kitti import readlines, savelines
from monodepth_tpu_torch.data.synthetic import make_kitti_tree, make_split_files
from monodepth_tpu_torch.losses.metrics import METRIC_NAMES
from monodepth_tpu_torch.training import Trainer
from monodepth_tpu_torch.training import checkpoint as checkpoint_module
from monodepth_tpu_torch.training.checkpoint import Checkpointer
from monodepth_tpu_torch.training.loop import _Meter, load_pretrained
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import make_train_multi_step, make_train_step
from monodepth_tpu_torch.utils.jax_export import jax_variables
from monodepth_tpu_torch.utils.serialization import load_npz, save_npz

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the shapes are tiny, and beside the other test
    workers on the host more threads only oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def remove_checkpoints(tmp_path):
    """Each test's states and exports take hundreds of MB: remove them
    when the test ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree; 4 train lines (2 steps of 2 an epoch), 2
    validation lines, 2 test lines."""
    root = str(tmp_path_factory.mktemp("kitti"))
    make_kitti_tree(root, num_frames=8, image_hw=(96, 320))
    splits = make_split_files(root, num_frames=8)
    train = os.path.join(splits, "kitti_eigen_zhou", "train_files.txt")
    savelines(readlines(train)[:4], train)
    return root, splits


def _cfg(tree, save_root, **kw):
    root, splits = tree
    base = dict(datapath=root, splits=splits, height=32, width=64, scales=(0, 1),
                batch=2, epoch=2, num_workers=2, precision="f32", weight_init=False,
                use_pallas=True, save_root=str(save_root), log_every=0, save="t")
    base.update(kw)
    return Config(**base)


def _assert_states_equal(a, b):
    """Parameters, buffers, Adam's state and the step, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["state"].keys() == ob["state"].keys()
    for i, entry in oa["state"].items():
        for key, value in entry.items():
            assert torch.equal(value, ob["state"][i][key]), (i, key)
    assert (a.step, a.seed) == (b.step, b.seed)


def _records(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _strip_times(record):
    record = {k: v for k, v in record.items() if k != "time"}
    for split in ("train", "valid"):
        record[split] = {k: v for k, v in record[split].items() if k != "img_per_sec"}
    return record


def test_resume_equals_uninterrupted_run(tree, tmp_path):
    whole = Trainer(_cfg(tree, tmp_path, save="whole"), device="cpu")
    whole.train()
    first = Trainer(_cfg(tree, tmp_path, save="split", epoch=1), device="cpu")
    first.train()
    resumed = Trainer(_cfg(tree, tmp_path, save="split", resume=True), device="cpu")
    assert resumed.start_epoch == 1
    resumed.train()

    _assert_states_equal(whole.state, resumed.state)
    assert whole.state.step == 2 * len(whole.train_loader) == 4
    ours, theirs = _records(whole.save_dir), _records(resumed.save_dir)
    assert [r["epoch"] for r in theirs] == [0, 1]
    assert [_strip_times(r) for r in ours] == [_strip_times(r) for r in theirs]
    assert ours[1]["warp_sampler"] == "cuda"
    assert {"loss", "warp_span", "warp_span_max"} <= set(ours[1]["train"])
    assert set(METRIC_NAMES) <= set(ours[1]["valid"])
    for name in os.listdir(os.path.join(whole.save_dir, "loss")):
        a = np.load(os.path.join(whole.save_dir, "loss", name))
        b = np.load(os.path.join(resumed.save_dir, "loss", name))
        assert a.shape == (2,) and np.array_equal(a, b, equal_nan=True), name
    for module in ("encoder", "decoder", "pose_encoder", "pose_decoder"):
        assert os.path.exists(os.path.join(whole.save_dir, f"{module}2.npz"))
    assert os.path.exists(os.path.join(whole.save_dir, "state_0001.pt"))


def test_plot_curves_reads_the_trainer_curves(tree, tmp_path, capsys):
    """`tools/plot_curves.py` (the JAX tool's copy) on a Trainer run: it
    reads every `loss/<split>_<metric>.npy` the run saved, one value an
    epoch, and renders them when matplotlib is there (else says so)."""
    from monodepth_tpu_torch.tools import plot_curves

    trainer = Trainer(_cfg(tree, tmp_path, save="curves"), device="cpu")
    trainer.train()
    curves = plot_curves.load_curves(trainer.save_dir)
    assert set(curves) == {"loss", *METRIC_NAMES}
    records = _records(trainer.save_dir)
    for metric, series in curves.items():
        assert set(series) == {"train", "valid"}, metric
        for split, values in series.items():
            saved = np.load(os.path.join(trainer.save_dir, "loss", f"{split}_{metric}.npy"))
            assert values.shape == (2,) and np.array_equal(values, saved, equal_nan=True)
    assert [r["train"]["loss"] for r in records] == list(curves["loss"]["train"])
    assert [r["valid"]["abs_rel"] for r in records] == list(curves["abs_rel"]["valid"])

    out = tmp_path / "curves.png"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert plot_curves.main([trainer.save_dir, str(out)]) == 1
        assert "matplotlib is not installed" in capsys.readouterr().out
    else:
        assert plot_curves.main([trainer.save_dir, str(out)]) == 0
        assert out.stat().st_size > 0
    assert plot_curves.main([]) == 2
    assert plot_curves.load_curves(str(tmp_path / "none")) == {}


@pytest.mark.parametrize("pose_type", ["separate", "shared", "posecnn"])
def test_stereo_epoch_exports_the_wirings_modules(tree, tmp_path, pose_type):
    """One epoch with `--dataset kitti_stereo` (mono+stereo: `validate`
    adds "s", the loader feeds `stereo_T` through `prefetch_to_device`):
    every train batch holds it, the losses are finite, and the exports hold
    the modules the wiring has, which `state_from_modules` reads back
    exactly."""
    from monodepth_tpu_torch.evaluation.eigen import state_from_modules

    trainer = Trainer(_cfg(tree, tmp_path, epoch=1, dataset="kitti_stereo",
                           pose_type=pose_type), device="cpu")
    assert trainer.cfg.frame_ids == (0, -1, 1, "s")
    batches, step = [], trainer.train_step

    def spy(state, batch):
        batches.append(batch)
        return step(state, batch)

    trainer.train_step = spy
    trainer.train()
    assert len(batches) == 2
    assert all(isinstance(b["stereo_T"], torch.Tensor) and b["stereo_T"].shape == (2, 4, 4)
               and b["frames"].shape[1] == 4 for b in batches)
    record = _records(trainer.save_dir)[0]
    assert np.isfinite([record["train"]["loss"], record["valid"]["loss"]]).all()
    expected = {"encoder", "decoder", "pose_decoder"} | (
        {"pose_encoder"} if pose_type == "separate" else set())
    exported = {name[:-5] for name in os.listdir(trainer.save_dir)
                if name.endswith("1.npz")}
    assert exported == expected
    loaded = state_from_modules(trainer.cfg, trainer.save_dir, 1, device="cpu")
    ours = trainer.model.state_dict()
    for key, value in loaded.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, ours[key]), key


def _state(cfg, seed):
    model = build_model(dataclasses.replace(cfg, seed=seed), device="cpu")
    state = create_state(cfg, model, steps_per_epoch=3)
    for p in model.parameters():  # Adam moments that differ from zero
        p.grad = torch.full_like(p, 0.01 * seed)
    state.apply_gradients()
    return state


def test_checkpointer_round_trip_and_keep(tree, tmp_path):
    cfg = _cfg(tree, tmp_path).validate()
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=2)
    saved = _state(cfg, 1)
    for epoch in range(3):
        ckpt.save(epoch, saved)
        ckpt.export_modules(epoch, saved)
    names = sorted(os.listdir(ckpt.directory))
    assert names == sorted(["state_0001.pt", "state_0002.pt"]
                           + [f"{m}{e}.npz" for e in (2, 3) for m in
                              ("encoder", "decoder", "pose_encoder", "pose_decoder")])
    assert ckpt.latest_epoch() == 2
    fresh = _state(cfg, 2)
    _, epoch = ckpt.restore(fresh)
    assert epoch == 2
    _assert_states_equal(saved, fresh)
    exported = load_npz(os.path.join(ckpt.directory, "encoder3.npz"))
    want = jax_variables(saved.model.state_dict(), cfg.num_layers, cfg.scales)
    for key, value in exported["params"]["conv1"].items():
        np.testing.assert_array_equal(value, want["params"]["encoder"]["conv1"][key])
    assert set(exported) == {"params", "batch_stats"}
    assert set(load_npz(os.path.join(ckpt.directory, "decoder3.npz"))) == {"params"}
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(fresh)


def test_async_save_snapshots_before_returning(tree, tmp_path, monkeypatch):
    """The write is held until the test has changed the parameters and the
    Adam moments in place; the file holds the state as it was at `save`."""
    cfg = _cfg(tree, tmp_path).validate()
    mutated = threading.Event()
    write = checkpoint_module.Checkpointer._write

    def held_write(self, path, snapshot):
        assert mutated.wait(60)
        write(self, path, snapshot)

    monkeypatch.setattr(checkpoint_module.Checkpointer, "_write", held_write)
    ckpt = Checkpointer(str(tmp_path / "ck"), async_save=True)
    state = _state(cfg, 1)
    before = _state(cfg, 1)
    ckpt.save(0, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for entry in state.optimizer.state.values():
            entry["exp_avg"].add_(1.0)
    state.step += 5
    mutated.set()
    ckpt.wait()
    fresh = _state(cfg, 2)
    ckpt.restore(fresh)
    _assert_states_equal(before, fresh)


def test_meter_sums_and_warp_span_max():
    meter = _Meter()
    for span in (2.0, 3.0, 150.0, 2.0):
        meter.update({"loss": torch.tensor(0.1), "warp_span": torch.tensor(span)})
    means = meter.means()
    assert means["warp_span"] == pytest.approx(39.25)
    assert means["warp_span_max"] == pytest.approx(150.0)
    assert means["loss"] == pytest.approx(0.1)
    stacked = _Meter()
    stacked.update({"loss": torch.ones(3), "warp_span": torch.tensor([1.0, 90.0, 2.0])})
    assert stacked.count == 3
    m2 = stacked.means()
    assert m2["warp_span_max"] == pytest.approx(90.0)
    assert m2["loss"] == pytest.approx(1.0)
    # stacked values add one by one: the same sums as single steps
    values = torch.rand(6, generator=torch.Generator().manual_seed(0))
    one, two = _Meter(), _Meter()
    for v in values:
        one.update({"loss": v})
    for pair in values.reshape(3, 2):
        two.update({"loss": pair})
    assert one.means() == two.means()
    assert all(np.isnan(v) for v in _Meter().means().values())


def _resnet_state_dict(cfg, seed):
    """A torchvision-layout resnet state dict (with `fc`), seeded."""
    model = build_model(dataclasses.replace(cfg, seed=seed), device="cpu")
    sd = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    sd["fc.weight"] = torch.randn(1000, 512, generator=torch.Generator().manual_seed(seed))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("form", ["pth", "npz", "missing"])
def test_load_pretrained(tree, tmp_path, form, capsys):
    cfg = _cfg(tree, tmp_path, weight_init=True,
               pretrained_dir=str(tmp_path / "pre")).validate()
    os.makedirs(cfg.pretrained_dir)
    sd = _resnet_state_dict(cfg, 7)
    path = os.path.join(cfg.pretrained_dir, f"resnet18.{form}")
    if form == "pth":
        torch.save(sd, path)
    elif form == "npz":
        full = {f"encoder.{k}": v for k, v in sd.items() if not k.startswith("fc.")}
        variables = jax_variables({**build_model(cfg, device="cpu").state_dict(), **full},
                                  cfg.num_layers, cfg.scales)
        save_npz(path, {"params": variables["params"]["encoder"],
                        "batch_stats": variables["batch_stats"]["encoder"]})
    model = build_model(cfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_pretrained(cfg, model)
    own = model.state_dict()
    if form == "missing":
        assert loaded is None
        assert "no pretrained resnet18" in capsys.readouterr().out
        assert all(torch.equal(own[k], v) for k, v in init.items())
        return
    assert loaded == path
    for key, value in sd.items():
        if key.startswith("fc.") or "num_batches" in key:
            continue
        assert torch.equal(own[f"encoder.{key}"], value), key
        want = torch.cat([value] * 2, 1) / 2 if key == "conv1.weight" else value
        assert torch.equal(own[f"pose_encoder.{key}"], want), key
    for key in own:  # the decoders stay at init
        if key.split(".")[0] in ("decoder", "pose_decoder"):
            assert torch.equal(own[key], init[key]), key


def test_steps_per_call_equals_single_steps(tree, tmp_path):
    """`make_train_multi_step` on 2 batches equals 2 single steps; the
    Trainer with `--steps_per_call 2` calls it once for its epoch's 2
    batches and ends where the single-step Trainer ends."""
    cfg = _cfg(tree, tmp_path).validate()
    trainer = Trainer(cfg, device="cpu")
    try:
        host = list(trainer.train_loader.epoch(0))
    finally:
        trainer.close()
    assert len(host) == 2
    one, two = _state(cfg, 1), _state(cfg, 1)
    single = make_train_step(one.model, cfg, device="cpu")
    multi = make_train_multi_step(two.model, cfg, device="cpu")
    metrics = [single(one, b) for b in host]
    stacked = multi(two, host)
    _assert_states_equal(one, two)
    for key in metrics[0]:
        assert torch.equal(torch.stack([m[key] for m in metrics]), stacked[key]), key

    trainers = {k: Trainer(_cfg(tree, tmp_path, save=f"k{k}", epoch=1, steps_per_call=k),
                           device="cpu") for k in (1, 2)}
    calls = []
    step = trainers[2].train_step
    trainers[2].train_step = lambda state, batches: calls.append(len(batches)) \
        or step(state, batches)
    for t in trainers.values():
        t.train()
    assert calls == [2]
    _assert_states_equal(trainers[1].state, trainers[2].state)
    assert trainers[2].state.step == 2
    ours, theirs = _records(trainers[1].save_dir), _records(trainers[2].save_dir)
    assert [_strip_times(r) for r in ours] == [_strip_times(r) for r in theirs]


def test_sigterm_checkpoints_and_stops_after_the_epoch(tree, tmp_path):
    trainer = Trainer(_cfg(tree, tmp_path, epoch=3, ckpt_every=5), device="cpu")
    epoch = trainer._epoch

    def first_epoch_signals(e, training):
        if training and e == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return epoch(e, training)

    trainer._epoch = first_epoch_signals
    previous = signal.getsignal(signal.SIGTERM)
    trainer.train()
    assert signal.getsignal(signal.SIGTERM) is previous
    assert [r["epoch"] for r in _records(trainer.save_dir)] == [0]
    assert trainer.checkpointer.latest_epoch() == 0
    assert os.path.exists(os.path.join(trainer.save_dir, "encoder1.npz"))
    assert trainer.state.step == len(trainer.train_loader)


def test_data_parallel_above_one_raises(tree, tmp_path):
    """In one process the mesh is that process: `--data_parallel 2` does
    not fit it (tests/test_torch_trainer_mesh.py runs the mesh)."""
    with pytest.raises(ValueError, match="covers every process of the group"):
        Trainer(_cfg(tree, tmp_path, data_parallel=2), device="cpu")


def test_train_cli_then_model_test_cli(tree, tmp_path):
    """`model_train --device cpu` for 2 epochs with a checkpoint each, then
    `--resume` to a third; `model_test --device cpu` scores the export."""
    root, splits = tree
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    flags = ["--device", "cpu", "--datapath", root, "--splits", splits,
             "--height", "32", "--width", "64", "--scales", "0 1", "--batch", "2",
             "--num_workers", "2", "--precision", "f32", "--weight_init", "false",
             "--save_root", str(tmp_path), "--save", "cli", "--ckpt_every", "1",
             "--ckpt_keep", "0", "--log_every", "0"]

    def run(module, *args):
        done = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr[-3000:]
        return done.stdout

    out = run("monodepth_tpu_torch.model_train", *flags, "--epoch", "2")
    assert ">>> epoch 2/2" in out
    save = tmp_path / "cli"
    assert {"state_0000.pt", "state_0001.pt", "encoder1.npz", "encoder2.npz",
            "decoder2.npz", "pose_encoder2.npz", "pose_decoder2.npz",
            "metrics.jsonl"} <= set(os.listdir(save))
    out = run("monodepth_tpu_torch.model_train", *flags, "--epoch", "3",
              "--resume", "true")
    assert ">>> resumed from epoch 1" in out
    assert np.load(save / "loss" / "train_loss.npy").shape == (3,)
    out = run("monodepth_tpu_torch.model_test", "--device", "cpu", "--datapath", root,
              "--splits", splits, "--height", "32", "--width", "64", "--eval_batch", "2",
              "--weights", f"{save}:3", "--gt_cache", "")
    rows = [line for line in out.splitlines() if re.match(r">>>\s+[\d.]+\s", line)]
    values = [float(v) for v in rows[-1].split()[1:]]
    assert len(values) == 7 and all(np.isfinite(values)), out


def _proof(mode):
    from monodepth_tpu_torch.tools import convergence_proof

    result = convergence_proof.main(["--mode", mode, "--steps", "3", "--height", "32",
                                     "--width", "64", "--batch", "2", "--scenes", "4",
                                     "--device", "cpu", "--use_pallas", "true"])
    assert result["mode"] == mode and result["steps"] == 3
    assert result["precision"] == "f32" and len(result["per_scene_corr"]) == 4
    assert np.isfinite([result["loss_first10"], result["rank_corr_trained_mean"]]).all()
    assert isinstance(result["pass"], bool)
    return result


def test_convergence_proof_runs_on_the_cpu():
    """The proof tool's mono path at a tiny size (3 steps: too few to pass
    its rule)."""
    assert _proof("mono")["frame_ids"] == ["0", "-1", "1"]


def test_convergence_proof_stereo_runs_on_the_cpu():
    """Its stereo path (the tool's default mode, as the JAX tool's): frames
    (0, "s"), the scenes' ground-truth baseline as `stereo_T`."""
    assert _proof("stereo")["frame_ids"] == ["0", "s"]
