"""The port's eval step on a {spatial: 2} mesh, each rank on its rows of
the frames (two gloo processes, `tests/torch_spatial_eval_worker.py`),
against JAX's eval step on a {data: 1, spatial: 2} mesh of the CPU's
virtual devices (GSPMD splits its ops by rows), with the warp kernels off
in both, from one converted init (`tests/torch_parity.py`) on one batch
and one tie-break noise, in f32: loss rtol 1e-4, as the one-device eval
parity (`tests/test_torch_step.py`). One JAX compile."""

import json
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
from monodepth_tpu.parallel import make_mesh as jmake_mesh
from monodepth_tpu.parallel import replicate as jreplicate
from monodepth_tpu.parallel import shard_batch as jshard_batch
from monodepth_tpu.training.state import TrainState as JTrainState
from monodepth_tpu.training.state import build_model as jbuild_model
from monodepth_tpu.training.step import make_eval_step as jmake_eval_step
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.training.state import build_model
from torch_parity import eval_noise, flax_variables, one_thread, randomize_bn_stats

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(height=32, width=128, batch=2, scales=(0, 1, 2, 3), precision="f32",
          weight_init=False, use_pallas=False)
STEP, INDEX = 3, 1


def test_spatial_eval_step_matches_jax(tmp_path, request):
    # the worker's ~0.1 GB inputs go when the test ends
    request.addfinalizer(lambda: shutil.rmtree(tmp_path, ignore_errors=True))
    cfg = Config(**KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=2)
    rng = np.random.default_rng(0)
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=0)
    gt = rng.uniform(0, 80, (cfg.batch, 375, 1242))
    batch = {"frames": scenes["frames"],
             "jitter": np.tile(np.array([1, 1.1, 0.9, 1.05, 0.02], np.float32),
                               (cfg.batch, 1)),
             "K": scenes["K"], "inv_K": scenes["inv_K"],
             "depth_gt": (gt * (rng.random(gt.shape) < 0.05)).astype(np.float32)}

    variables = flax_variables(model.state_dict(), cfg)
    jstate = JTrainState(step=jnp.int32(STEP), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=None,
                         rng=jax.random.PRNGKey(cfg.seed))
    mesh = jmake_mesh(1, 2)
    theirs = jmake_eval_step(jbuild_model(JConfig(**KW)), JConfig(**KW), mesh=mesh)(
        jreplicate(mesh, jstate), jshard_batch(mesh, batch), jnp.uint32(INDEX))

    torch.save({"cfg": KW, "state_dict": model.state_dict(), "batch": batch,
                "noise": eval_noise(jstate.rng, STEP, INDEX, cfg), "step": STEP,
                "index": INDEX}, tmp_path / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_spatial_eval_worker.py"),
                           str(tmp_path / "inputs.pt"), str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=660)
    assert done.returncode == 0, done.stderr[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert ranks[0] == ranks[1]
    # the kernels off: each of the 8 warps of a rank is the exact fallback
    assert ranks[0].pop("fallbacks") == 8
    assert set(ranks[0]) == set(theirs)
    np.testing.assert_allclose(ranks[0]["loss"], float(theirs["loss"]), rtol=1e-4)
