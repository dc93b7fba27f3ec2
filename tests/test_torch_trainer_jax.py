"""The port's Trainer against the JAX Trainer: one epoch of each on one
synthetic KITTI tree from one init, f32, the plain warp on both sides
(`use_pallas=False`) and no automasking, so neither side draws tie-break
noise. The shape is `tests/test_eval_trainer.py`'s `make_cfg`: 32x64,
scales (0, 1), batch 2; 6 train lines (3 train steps) and 1 validation
step.

The JAX Trainer's state is replaced by the port's seeded init, converted
(`torch_parity.flax_variables`, Adam's state from `trainer.tx.init`).
Bounds are `tests/test_torch_train_traj.py`'s: the epoch's train and valid
losses rtol 1e-3, the exported parameters atol 2e-3, the exported
batch-norm statistics atol 5e-2 (they drift with the parameters). Measured
on the CPU: losses rel 6.1e-6 (train) and 5.5e-5 (valid), parameters
max |diff| 3.4e-4, statistics 2.1e-3.

Three Adam steps at lr 1e-4 move a parameter by at most ~3e-4, under the
atol, so the update itself is held apart: per module, the port's change
from the init (export minus init) against JAX's, as
|Δport - Δjax| / |Δjax| <= 0.25 (L2 over the module's parameters).
Measured on the CPU: encoder 0.013, decoder 0.0095, pose encoder 0.14,
pose decoder 0.067 (Adam's first steps normalize each coordinate, so
those with near-zero gradients, most in the pose net, move by ±lr on
rounding). Controls: a port that skips the update reads 1; one at half
the learning rate read 0.63, 0.54, 0.66 and 0.62.

The JAX package's `state_from_modules` reads the port's export, equal to
the port's model exactly."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.evaluation.eigen import state_from_modules as jstate_from_modules
from monodepth_tpu.parallel import make_mesh, replicate
from monodepth_tpu.training import Trainer as JTrainer
from monodepth_tpu.training.state import TrainState as JTrainState
from monodepth_tpu.utils.serialization import load_npz
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.kitti import readlines
from monodepth_tpu_torch.data.synthetic import make_kitti_tree, make_split_files
from monodepth_tpu_torch.training.loop import Trainer
from torch_parity import flax_variables

KW = dict(height=32, width=64, scales=(0, 1), batch=2, epoch=1, num_workers=2,
          precision="f32", weight_init=False, use_pallas=False,
          use_automasking=False, log_every=0)
TRAIN_LINES = 6  # 3 train steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port save dir, JAX save dir, port Trainer, cfg, the converted
    init's variables). One intra-op
    thread for torch while the Trainers run: the shapes are tiny, and
    beside the other test workers more threads oversubscribe the host."""
    root = str(tmp_path_factory.mktemp("kitti"))
    make_kitti_tree(root, num_frames=8, image_hw=(96, 320))
    splits = make_split_files(root, num_frames=8)
    train_files = readlines(os.path.join(splits, "kitti_eigen_zhou",
                                         "train_files.txt"))[:TRAIN_LINES]
    save_root = str(tmp_path_factory.mktemp("save"))
    kw = dict(KW, datapath=root, splits=splits, save_root=save_root)
    cfg = Config(save="port", **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trainer = Trainer(cfg, device="cpu", train_files=train_files)
        variables = flax_variables(trainer.model.state_dict(), cfg)

        mesh = make_mesh(1, 1)
        jtrainer = JTrainer(JConfig(save="jax", **kw), mesh=mesh,
                            train_files=train_files)
        jtrainer.state = replicate(mesh, JTrainState(
            step=jnp.int32(0), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=jtrainer.tx.init(variables["params"]), rng=jtrainer.state.rng))
        trainer.train()
        jtrainer.train()
    finally:
        torch.set_num_threads(threads)
    yield trainer.save_dir, jtrainer.save_dir, trainer, cfg, variables
    shutil.rmtree(save_root, ignore_errors=True)  # states and exports, ~0.5 GB


def _record(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1
    return records[0]


def test_epoch_losses_match_jax(runs):
    ours, theirs = _record(runs[0]), _record(runs[1])
    for split in ("train", "valid"):
        np.testing.assert_allclose(ours[split]["loss"], theirs[split]["loss"], rtol=1e-3)
    np.testing.assert_allclose(ours["valid"]["abs_rel"], theirs["valid"]["abs_rel"],
                               rtol=1e-3)
    assert ours["lr"] == theirs["lr"]
    assert "warp_sampler" not in ours and "warp_sampler" not in theirs


@pytest.mark.parametrize("module", ["encoder", "decoder", "pose_encoder", "pose_decoder"])
def test_exports_match_jax(runs, module):
    ours = load_npz(os.path.join(runs[0], f"{module}1.npz"))
    theirs = load_npz(os.path.join(runs[1], f"{module}1.npz"))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=2e-3),
                 ours["params"], theirs["params"])
    if "batch_stats" in theirs:
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=5e-2),
                     ours["batch_stats"], theirs["batch_stats"])


@pytest.mark.parametrize("module", ["encoder", "decoder", "pose_encoder", "pose_decoder"])
def test_export_updates_match_jax(runs, module):
    init = runs[4]["params"][module]

    def update(save_dir):
        params = load_npz(os.path.join(save_dir, f"{module}1.npz"))["params"]
        assert jax.tree.structure(params) == jax.tree.structure(init)
        return np.concatenate([
            (np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
            for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(init))])

    ours, theirs = update(runs[0]), update(runs[1])
    assert np.linalg.norm(theirs) > 0
    assert np.linalg.norm(ours - theirs) / np.linalg.norm(theirs) <= 0.25


def test_jax_state_from_modules_reads_the_port_export(runs):
    save_dir, _, trainer, cfg, _ = runs
    jcfg = JConfig(**{k: getattr(cfg, k) for k in KW}, datapath=cfg.datapath,
                   splits=cfg.splits)
    state = jax.device_get(jstate_from_modules(jcfg, save_dir, 1))
    want = flax_variables({k: v for k, v in trainer.model.state_dict().items()
                           if isinstance(v, torch.Tensor)}, cfg)
    jax.tree.map(np.testing.assert_array_equal, state.params, want["params"])
    jax.tree.map(np.testing.assert_array_equal, state.batch_stats, want["batch_stats"])
