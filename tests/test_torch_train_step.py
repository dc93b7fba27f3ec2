"""The port's train step against the JAX package in float64: one step from
one converted init, loss and per-module gradients against
`jax.value_and_grad` of the JAX `apply_and_warp` + `_loss_from_outputs`
under `jax.enable_x64`, as tools/lockstep_oracle.py does. In f64 the two
frameworks' rounding vanishes (~1e-14) and only a difference of semantics
would remain: the bar of docs/PARITY.md is loss rel < 1e-12 and
per-module grad rel < 1e-10. The plain warp (`use_pallas=False`) runs on
both sides: the Pallas kernel is f32-only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.models.monodepth import Monodepth as JMonodepth
from monodepth_tpu.training.step import _loss_from_outputs, apply_and_warp
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import make_train_step
from torch_parity import (
    flax_variables,
    grads_as_flax,
    one_thread,
    randomize_bn_stats,
    train_noise,
)

pytestmark = pytest.mark.usefixtures("one_thread")

KW = dict(height=32, width=128, batch=2, scales=(0, 1, 2, 3), precision="f32",
          weight_init=False, use_pallas=False)
MODULES = ("encoder", "decoder", "pose_encoder", "pose_decoder")


def _batch(cfg, dtype):
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=5,
                                tx_sign=1.0)
    jitter = np.tile(np.array([1, 1.1, 0.9, 1.05, 0.02]), (cfg.batch, 1))
    return {"frames": scenes["frames"], "jitter": jitter.astype(dtype),
            "K": scenes["K"].astype(dtype), "inv_K": scenes["inv_K"].astype(dtype)}


@pytest.fixture(scope="module")
def one_step():
    """(port loss, JAX loss, port grads, JAX grads) of one f64 step."""
    cfg = Config(**KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=4)
    model.double()
    variables = flax_variables(model.state_dict(), cfg)
    batch = _batch(cfg, np.float64)
    rng0 = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        noise = train_noise(rng0, 0, cfg, np.float64)
        jmodel = JMonodepth(num_layers=cfg.num_layers, scales=cfg.scales,
                            frame_ids=cfg.frame_ids, pose_type=cfg.pose_type,
                            pose_frames=cfg.pose_frames, dtype=jnp.float64)
        jcfg = JConfig(**KW)
        batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
        stats = jax.tree.map(jnp.asarray, variables["batch_stats"])

        def loss_fn(params):
            out = apply_and_warp(jmodel, {"params": params, "batch_stats": stats},
                                 batch_j, jcfg, train=True)
            return _loss_from_outputs(out, jax.random.fold_in(rng0, 0), jcfg,
                                      train=True)[0]

        j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree.map(jnp.asarray, variables["params"]))
        j_loss, j_grads = float(j_loss), jax.device_get(j_grads)

    state = create_state(cfg, model, steps_per_epoch=10)
    metrics = make_train_step(model, cfg, device="cpu")(state, batch, noise=noise)
    assert state.step == 1
    return float(metrics["loss"]), j_loss, grads_as_flax(model, cfg), j_grads


def test_train_step_loss_matches_jax_f64(one_step):
    t_loss, j_loss, *_ = one_step
    assert abs(t_loss - j_loss) / abs(j_loss) < 1e-12, (t_loss, j_loss)


@pytest.mark.parametrize("module", MODULES)
def test_train_step_grads_match_jax_f64(one_step, module):
    """max |port - JAX| over the module's gradients, over max |JAX|."""
    *_, t_grads, j_grads = one_step
    ours = jax.tree.leaves(t_grads[module])
    theirs = jax.tree.leaves(j_grads[module])
    assert len(ours) == len(theirs) > 0
    assert all(a.dtype == np.float64 for a in ours)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(ours, theirs))
    scale = max(float(np.abs(b).max()) for b in theirs)
    assert scale > 0 and diff / scale < 1e-10, (module, diff, scale)
