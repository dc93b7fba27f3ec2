"""The port's train step along the kernel path against the JAX train step,
f32: 4 steps from one converted init, the warps through `WarpSample`
(the CUDA kernel's plain version on the CPU) on one side and the Pallas
kernel in interpret mode on the other, Adam under the StepLR schedule on
both (steps_per_epoch 2, scheduler_step 1: the learning rate drops 10x
after step 1). The tie-break noise is the JAX step's own
(fold_in(rng, step), one split per scale).

Bounds as tests/test_pallas.py:270-281, where chaos amplifies f32
rounding: step-0 loss rtol 1e-5, every loss rtol 1e-3, params atol 2e-3.
Batch-norm running statistics: atol 1e-4 after the first step (measured
2.6e-6; a wrong update, such as torch's unbiased variance, is off by
~1e-2 there). After 4 steps they drift with the parameters: Adam's first
update is ~lr·sign(g), so gradients near 0 that round to opposite signs
move a weight by 2e-4, and the pose encoder's layer4 normalizes only 8
values per channel at this size; measured max |diff| 0.020 (of values up
to 1.5), held at atol 0.05."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.training.state import TrainState as JTrainState
from monodepth_tpu.training.state import build_model as jbuild_model
from monodepth_tpu.training.state import make_optimizer as jmake_optimizer
from monodepth_tpu.training.step import make_train_step as jmake_train_step
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.ops.cuda.warp_sample import warp_sample, warp_sample_grads
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import make_train_step
from test_torch_step import _batch
from torch_parity import flax_variables, randomize_bn_stats, train_noise

KW = dict(height=32, width=128, batch=2, scales=(0, 1, 2, 3), precision="f32",
          weight_init=False, use_pallas=True, pallas_interpret=True,
          scheduler_step=1)
STEPS, STEPS_PER_EPOCH = 4, 2


def _run(gt_metrics: bool, steps: int):
    """(port metrics, JAX metrics, port state, JAX state, cfg, running
    statistics of both after the first step) after `steps` steps."""
    cfg = Config(**KW, train_gt_metrics=gt_metrics)
    jcfg = JConfig(**KW, train_gt_metrics=gt_metrics)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=6)
    variables = flax_variables(model.state_dict(), cfg)
    tx = jmake_optimizer(jcfg, steps_per_epoch=STEPS_PER_EPOCH)
    jstate = JTrainState(step=jnp.int32(0), params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=tx.init(variables["params"]),
                         rng=jax.random.PRNGKey(cfg.seed))
    jstep = jmake_train_step(jbuild_model(jcfg), tx, jcfg)
    state = create_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    step = make_train_step(model, cfg, device="cpu")
    batches = [_batch(cfg, seed) for seed in (0, 1)]
    ours, theirs = [], []
    for k in range(steps):
        batch = batches[k % 2]
        noise = train_noise(jstate.rng, k, cfg)
        ours.append(step(state, batch, noise=noise))
        jstate, metrics = jstep(jstate, batch)
        theirs.append(jax.device_get(metrics))
        if k == 0:
            first = (flax_variables(model.state_dict(), cfg)["batch_stats"],
                     jax.device_get(jstate.batch_stats))
    return ours, theirs, state, jax.device_get(jstate), cfg, first


@pytest.fixture(scope="module")
def trajectory():
    before = (warp_sample.launches, warp_sample_grads.launches)
    run = _run(True, STEPS)
    assert (warp_sample.launches, warp_sample_grads.launches) == before
    return run


def test_trajectory_losses_match_jax(trajectory):
    ours, theirs, state, jstate, *_ = trajectory
    t = [float(m["loss"]) for m in ours]
    j = [float(m["loss"]) for m in theirs]
    assert abs(t[0] - j[0]) / abs(j[0]) < 1e-5, (t, j)
    np.testing.assert_allclose(t, j, rtol=1e-3)
    assert state.step == int(jstate.step) == STEPS


def test_trajectory_params_and_stats_match_jax(trajectory):
    _, _, state, jstate, cfg, (stats1, jstats1) = trajectory
    ours = flax_variables(state.model.state_dict(), cfg)
    assert jax.tree.structure(ours["params"]) == jax.tree.structure(jstate.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=2e-3),
                 ours["params"], jstate.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-4),
                 stats1, jstats1)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=5e-2),
                 ours["batch_stats"], jstate.batch_stats)


def test_trajectory_metrics_match_jax(trajectory):
    """--train_gt_metrics on: loss, warp_span and the 7 depth metrics."""
    ours, theirs, *_ = trajectory
    assert set(ours[0]) == set(theirs[0])
    assert {"loss", "warp_span", "abs_rel"} <= set(ours[0])
    for m, n in zip(ours, theirs):
        assert abs(float(m["warp_span"]) - float(n["warp_span"])) <= 0.125
        np.testing.assert_allclose(float(m["abs_rel"]), float(n["abs_rel"]),
                                   rtol=1e-3)


def test_metric_keys_without_gt_metrics_match_jax():
    """--train_gt_metrics off: one step each, the same keys, no depth
    metrics though the batch has ground truth."""
    ours, theirs, *_ = _run(False, 1)
    assert set(ours[0]) == set(theirs[0]) == {"loss", "warp_span"}
    assert abs(float(ours[0]["loss"]) - float(theirs[0]["loss"])) \
        / abs(float(theirs[0]["loss"])) < 1e-5
