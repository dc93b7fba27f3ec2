"""The port's train step against the JAX package in float64 for two pose
wirings, as tests/test_torch_train_step.py holds the `separate` one: one
step from one converted init, loss and per-module gradients against
`jax.value_and_grad` of the JAX `apply_and_warp` + `_loss_from_outputs`
under `jax.enable_x64`, with the plain warp on both sides. Bar: loss rel
< 1e-12, per-module grad rel < 1e-10 (docs/PARITY.md).

- `posecnn` with frames (0, -1, 1, "s"): PoseCNN on channel-stacked
  frames, each temporal source's transform rebuilt per scale from the
  translation times the mean inverse depth of that scale (differentiated
  through the depth), and the stereo frame warped by the batch's
  `stereo_T`: 12 warps;
- `shared` with `pose_frames="all"`: one depth-encoder pass over every
  frame stacked on the batch axis (batch norm over B·F images), one joint
  pose pass over the pyramids of frames (0, -1, 1), no transform
  inverted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.models.monodepth import Monodepth as JMonodepth
from monodepth_tpu.training.step import _loss_from_outputs, apply_and_warp
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.training.state import build_model, create_state, model_modules
from monodepth_tpu_torch.training.step import make_train_step
from torch_parity import (  # noqa: F401 (one_thread: a fixture)
    flax_variables,
    grads_as_flax,
    one_thread,
    randomize_bn_stats,
    train_noise,
)

pytestmark = pytest.mark.usefixtures("one_thread")

BASE = dict(height=32, width=64, batch=2, scales=(0, 1, 2, 3), precision="f32",
            weight_init=False, use_pallas=False)
CASES = {"posecnn_stereo": dict(pose_type="posecnn", frame_ids=(0, -1, 1, "s")),
         "shared_all": dict(pose_type="shared", pose_frames="all")}


def _batch(cfg, dtype):
    """`make_planar_scenes` frames (0, -1, +1); with "s", the +tx view again
    as the stereo frame, with its ground-truth baseline as `stereo_T`."""
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=5, tx_sign=1.0)
    jitter = np.tile(np.array([1, 1.1, 0.9, 1.05, 0.02]), (cfg.batch, 1))
    batch = {"frames": scenes["frames"], "jitter": jitter.astype(dtype),
             "K": scenes["K"].astype(dtype), "inv_K": scenes["inv_K"].astype(dtype)}
    if "s" in cfg.frame_ids:
        batch["frames"] = scenes["frames"][:, [0, 1, 2, 2]]
        stereo_T = np.tile(np.eye(4), (cfg.batch, 1, 1))
        stereo_T[:, 0, 3] = scenes["gt_tx"]
        batch["stereo_T"] = stereo_T.astype(dtype)
    return batch


@pytest.fixture(scope="module", params=list(CASES))
def one_step(request):
    """(config, port loss, JAX loss, port grads, JAX grads) of one f64 step."""
    kw = {**BASE, **CASES[request.param]}
    cfg = Config(**kw)
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
        jcfg = JConfig(**kw)
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
    assert set(j_grads) == set(model_modules(model))
    return cfg, float(metrics["loss"]), j_loss, grads_as_flax(model, cfg), j_grads


def test_train_step_loss_matches_jax_f64(one_step):
    _, t_loss, j_loss, *_ = one_step
    assert abs(t_loss - j_loss) / abs(j_loss) < 1e-12, (t_loss, j_loss)


def test_train_step_grads_match_jax_f64(one_step):
    """For each module the wiring has: max |port - JAX| over its gradients,
    over max |JAX|."""
    *_, t_grads, j_grads = one_step
    for module in j_grads:
        ours = jax.tree.leaves(t_grads[module])
        theirs = jax.tree.leaves(j_grads[module])
        assert len(ours) == len(theirs) > 0
        assert all(a.dtype == np.float64 for a in ours)
        diff = max(float(np.abs(a - b).max()) for a, b in zip(ours, theirs))
        scale = max(float(np.abs(b).max()) for b in theirs)
        assert scale > 0 and diff / scale < 1e-10, (module, diff, scale)
