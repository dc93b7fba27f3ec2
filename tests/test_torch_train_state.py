"""The port's training state against the JAX package: train-mode batch norm
(the biased running variance, fault 2), the StepLR schedule, one Adam
update against optax, and optax's Adam state carried across by
`optimizer_state_from_jax`. Plus the model mode of the steps (fault 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.models import ResNetEncoder as JResNetEncoder
from monodepth_tpu.training.state import make_optimizer as jmake_optimizer
from monodepth_tpu.training.state import step_decay_schedule as jschedule
from monodepth_tpu.utils import torch_import
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.models.resnet import ResNetEncoder
from monodepth_tpu_torch.training.state import (
    build_model,
    create_state,
    step_decay_schedule,
)
from monodepth_tpu_torch.training.step import (
    make_eval_step,
    make_infer_step,
    make_train_step,
)
from monodepth_tpu_torch.utils.jax_import import (
    optimizer_state_from_jax,
    state_dict_from_jax,
)
from torch_parity import flax_variables, one_thread, randomize_bn_stats

pytestmark = pytest.mark.usefixtures("one_thread")

KW = dict(height=32, width=128, batch=2, scales=(0, 1, 2, 3), precision="f32",
          weight_init=False, scheduler_step=1)


def test_bn_train_update_matches_flax(rng):
    """One train-mode forward of the encoder: running means and variances
    as flax's mutated batch_stats. At 64x64, batch 2, layer4 normalizes
    n = 2·2·2 = 8 values per channel, where torch's unbiased variance
    would be 8/7 of flax's. The init is drawn from a seeded generator: from
    torch's global one it depended on the tests that ran before in the
    process. The bound scales with the statistics (up to ~1.5): the two
    sides sum a channel's values in another order, so the gap is a few
    f32 roundings of a value's size. Over init seeds 0-11 on the CPU the
    largest |diff| - 1e-6·|flax| read 5.6e-7 (|diff| up to 1.9e-6); a BN
    that stored the unbiased variance reads 2.8e-2."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        enc = ResNetEncoder(18, 1)
    randomize_bn_stats(enc, seed=1)
    variables = torch_import.resnet_encoder_variables(
        {k: v.numpy() for k, v in enc.state_dict().items()}, 18)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _, mutated = JResNetEncoder(num_layers=18).apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    enc.train()
    with torch.no_grad():
        enc(torch.from_numpy(x).permute(0, 3, 1, 2))
    ours = torch_import.resnet_encoder_variables(
        {k: v.numpy() for k, v in enc.state_dict().items()}, 18)["batch_stats"]
    theirs = jax.device_get(mutated["batch_stats"])
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6),
                 ours, theirs)


def test_schedule_matches_jax_across_two_epoch_boundaries():
    ours = step_decay_schedule(1e-4, 1, 3)
    theirs = jschedule(1e-4, 1, 3)
    lrs = [ours(k) for k in range(9)]
    assert lrs == [theirs(k) for k in range(9)]
    assert len(set(lrs)) == 3  # 1e-4, 1e-5, 1e-6: boundaries at 3 and 6


@pytest.fixture(scope="module")
def init():
    """A seeded port model and its JAX params tree (f32)."""
    cfg = Config(**KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=3)
    return cfg, model.state_dict()


def _random_grads(params, rng, dtype):
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(np.shape(p)), dtype), params)


def _set_grads(model, grads, batch_stats, cfg):
    sd = state_dict_from_jax({"params": grads, "batch_stats": batch_stats}, cfg)
    for name, p in model.named_parameters():
        p.grad = sd[name].to(p.dtype)


def _port_params_as_flax(model, cfg):
    return flax_variables(model.state_dict(), cfg)["params"]


def test_adam_updates_match_optax_f64(init, rng):
    """Two Adam updates from the same f64 gradients, with the learning rate
    dropping 10x after the first (steps_per_epoch 1, scheduler_step 1):
    the port's `apply_gradients` against `optax.adam` under the JAX
    package's `make_optimizer`, to 1e-12."""
    cfg, sd = init
    model = build_model(cfg, device="cpu").double()
    model.load_state_dict(sd)
    state = create_state(cfg, model, steps_per_epoch=1)
    variables = flax_variables(model.state_dict(), cfg)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"])
        tx = jmake_optimizer(JConfig(**KW), steps_per_epoch=1)
        update = jax.jit(tx.update)
        opt_state = tx.init(params)
        for _ in range(2):
            grads = _random_grads(params, rng, jnp.float64)
            updates, opt_state = update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            _set_grads(model, jax.device_get(grads), variables["batch_stats"], cfg)
            state.apply_gradients()
        theirs = jax.device_get(params)
    assert state.step == 2
    ours = _port_params_as_flax(model, cfg)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-12),
                 ours, theirs)


def test_optimizer_state_carries_over_from_jax(init, rng):
    """Two optax Adam updates in JAX, then params and `opt_state` carried
    into the port (`state_dict_from_jax`, `optimizer_state_from_jax`);
    one more update on both sides from the same gradients."""
    cfg, sd = init
    variables = flax_variables(sd, cfg)
    params, batch_stats = variables["params"], variables["batch_stats"]
    tx = jmake_optimizer(JConfig(**KW), steps_per_epoch=1)
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    for _ in range(2):
        updates, opt_state = update(_random_grads(params, rng, jnp.float32),
                                    opt_state, params)
        params = optax.apply_updates(params, updates)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        {"params": jax.device_get(params), "batch_stats": batch_stats}, cfg))
    state = create_state(cfg, model, steps_per_epoch=1)
    state.optimizer.load_state_dict(
        optimizer_state_from_jax(jax.device_get(opt_state), model))
    state.step = 2
    loaded = state.optimizer.state[next(model.parameters())]
    assert float(loaded["step"]) == 2.0
    np.testing.assert_array_equal(
        loaded["exp_avg"].permute(2, 3, 1, 0).numpy(),
        np.asarray(opt_state[0].mu["encoder"]["conv1"]["kernel"]))

    grads = _random_grads(params, rng, jnp.float32)
    updates, opt_state = update(grads, opt_state, params)
    theirs = jax.device_get(optax.apply_updates(params, updates))
    _set_grads(model, jax.device_get(grads), batch_stats, cfg)
    state.apply_gradients()
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-6),
                 _port_params_as_flax(model, cfg), theirs)


def _batch(cfg, seed=0):
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=seed)
    return {k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")}


def _running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}


def test_eval_and_infer_after_a_train_step_run_in_eval_mode(init):
    """Fault 3: an eval step right after a train step gives the loss of a
    fresh model loaded with the trained weights, and leaves the running
    statistics alone; so does inference."""
    cfg, sd = init
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    state = create_state(cfg, model, steps_per_epoch=10)
    batch = _batch(cfg)
    noise = {s: 1e-5 * torch.randn(2, 32, 128, 2,
                                   generator=torch.Generator().manual_seed(s))
             for s in cfg.scales}
    make_train_step(model, cfg, device="cpu")(state, batch)
    assert model.training
    stats = _running_stats(model)

    loss = make_eval_step(model, cfg, device="cpu")(state, batch, noise=noise)["loss"]
    images = batch["frames"][:, 0].astype(np.float32) / 255.0
    depth = make_infer_step(model, cfg, device="cpu")(images)
    for k, v in _running_stats(model).items():
        assert torch.equal(v, stats[k]), k

    fresh = build_model(cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    fresh_loss = make_eval_step(fresh, cfg, device="cpu")(
        create_state(cfg, fresh), batch, noise=noise)["loss"]
    np.testing.assert_allclose(float(loss), float(fresh_loss), rtol=1e-7)
    np.testing.assert_allclose(depth.numpy(), make_infer_step(
        fresh, cfg, device="cpu")(images).numpy(), rtol=1e-6)


def test_train_step_needs_an_optimizer(init):
    cfg, _ = init
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    with pytest.raises(ValueError, match="steps_per_epoch"):
        step(create_state(cfg, model), _batch(cfg))
