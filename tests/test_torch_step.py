"""The forward slice as a whole: the port's eval and infer steps against
the JAX steps (Pallas warp kernel in interpret mode) from one converted
init, on the same batch and the same tie-break noise. Plus the port's
isolation from jax and its device rule."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.training.state import TrainState as JTrainState
from monodepth_tpu.training.state import build_model as jbuild_model
from monodepth_tpu.training.step import make_eval_step as jmake_eval_step
from monodepth_tpu.training.step import make_infer_step as jmake_infer_step
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.ops.cuda.warp_sample import warp_sample
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import (
    make_eval_step,
    make_infer_step,
    make_train_step,
)
from torch_parity import eval_noise, flax_variables, one_thread, randomize_bn_stats

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(height=32, width=128, batch=2, scales=(0, 1, 2, 3), precision="f32",
          weight_init=False, use_pallas=True, pallas_interpret=True)
STEP, INDEX = 3, 1


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=seed)
    gt = rng.uniform(0, 80, (cfg.batch, 375, 1242))
    gt = (gt * (rng.random(gt.shape) < 0.05)).astype(np.float32)
    jitter = np.tile(np.array([1, 1.1, 0.9, 1.05, 0.02], np.float32),
                     (cfg.batch, 1))
    return {"frames": scenes["frames"], "jitter": jitter, "K": scenes["K"],
            "inv_K": scenes["inv_K"], "depth_gt": gt}


@pytest.fixture(scope="module")
def pair():
    """(port model, its state, the JAX model and state) from one init."""
    cfg = Config(**KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=2)
    variables = flax_variables(model.state_dict(), cfg)
    jcfg = JConfig(**KW)
    jstate = JTrainState(step=jnp.int32(STEP), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=None,
                         rng=jax.random.PRNGKey(cfg.seed))
    state = create_state(cfg, model)
    state.step = STEP
    return cfg, model, state, jbuild_model(jcfg), jcfg, jstate


def test_eval_step_matches_jax(pair):
    cfg, model, state, jmodel, jcfg, jstate = pair
    batch = _batch(cfg)
    theirs = jmake_eval_step(jmodel, jcfg)(jstate, batch, jnp.uint32(INDEX))
    noise = eval_noise(jstate.rng, STEP, INDEX, cfg)
    ours = make_eval_step(model, cfg, device="cpu")(state, batch, INDEX,
                                                    noise=noise)
    assert set(ours) == set(theirs)
    # f32 convs round differently in the two frameworks (~1e-6 rel); a
    # wrong warp or loss term is off by O(1e-2)
    np.testing.assert_allclose(float(ours["loss"]), float(theirs["loss"]),
                               rtol=1e-4)
    # one floor flip at a rounding boundary moves the mean of 8 slabs by 1/8
    assert abs(float(ours["warp_span"]) - float(theirs["warp_span"])) <= 0.125


def test_eval_step_draws_its_noise_by_batch(pair):
    """Without `noise`, the noise is keyed by (seed, step, index): the same
    index repeats, another index draws anew (the loss moves by ~1e-6)."""
    cfg, model, state, *_ = pair
    batch = _batch(cfg, seed=1)
    step = make_eval_step(model, cfg, device="cpu")
    a, b, c = (float(step(state, batch, i)["loss"]) for i in (0, 0, 1))
    assert a == b and a != c
    assert abs(a - c) / a < 1e-3


def test_infer_step_matches_jax(pair):
    cfg, model, state, jmodel, jcfg, jstate = pair
    images = _batch(cfg)["frames"][:, 0].astype(np.float32) / 255.0
    theirs = np.asarray(jmake_infer_step(jmodel, jcfg)(jstate, jnp.asarray(images)))
    ours = make_infer_step(model, cfg, device="cpu")(images)
    assert ours.shape == theirs.shape == (cfg.batch, cfg.height, cfg.width)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4)


def test_eval_step_without_kernels_uses_grid_sample(pair):
    cfg, model, state, *_ = pair
    batch = _batch(cfg)
    plain_cfg = Config(**{**KW, "use_pallas": False})
    ours = make_eval_step(model, cfg, device="cpu")(state, batch, INDEX)
    plain = make_eval_step(model, plain_cfg, device="cpu")(state, batch, INDEX)
    assert "warp_span" in ours and "warp_span" not in plain
    np.testing.assert_allclose(float(plain["loss"]), float(ours["loss"]),
                               rtol=1e-6)


def test_eval_step_feeds_the_kernel_what_it_takes(pair):
    """The 8 warps of a step get what the CUDA kernel accepts: contiguous
    float32 NHWC sources and grids of one shape."""
    cfg, model, state, *_ = pair
    seen = []

    def sampler(image, grid):
        seen.append((image.is_contiguous() and grid.is_contiguous(),
                     image.dtype, grid.dtype, tuple(image.shape),
                     tuple(grid.shape)))
        return warp_sample(image, grid)

    make_eval_step(model, cfg, device="cpu", sampler=sampler)(state, _batch(cfg))
    B, H, W = cfg.batch, cfg.height, cfg.width
    assert seen == [(True, torch.float32, torch.float32, (B, H, W, 3),
                     (B, H, W, 2))] * 8


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    cfg = Config(**KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    for make in (make_eval_step, make_infer_step, make_train_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(model, cfg)
    before = warp_sample.launches
    make_eval_step(model, cfg, device="cpu")(create_state(cfg, model),
                                              _batch(cfg))
    assert warp_sample.launches == before  # CPU tensors never launch


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "monodepth_tpu")


def _port_sources():
    return sorted((ROOT / "monodepth_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _BLOCKED, (path, name)


def test_port_runs_with_jax_blocked():
    """Every module of the port imports, and the CPU eval and train steps
    run, in a process where importing jax, flax, optax or monodepth_tpu
    fails."""
    code = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np
import monodepth_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import make_eval_step, make_train_step
cfg = Config(height=32, width=64, batch=2, precision="f32")
model = build_model(cfg, device="cpu")
scenes = make_planar_scenes(2, 32, 64)
batch = {{k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")}}
state = create_state(cfg, model, steps_per_epoch=10)
train = float(make_train_step(model, cfg, device="cpu")(state, batch)["loss"])
loss = float(make_eval_step(model, cfg, device="cpu")(state, batch)["loss"])
assert np.isfinite(train) and np.isfinite(loss) and state.step == 1, (train, loss)
print("OK", train, loss)
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.startswith("OK")


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """With no card, or alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        done = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env={**os.environ, "PYTHONPATH": ""})
        assert done.returncode != 0, done.stdout
        assert '"ok": true' not in done.stdout
