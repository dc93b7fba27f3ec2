"""The plain reference against the port's CPU path, in float64 at 64x96
and batch 2, for both configurations: two train steps' losses, the first
step's gradients and finest disparity, the parameters after Adam's second
update and the batch-norm running statistics. Both sides load one seeded
state_dict and take the same batches and noise."""

import dataclasses

import pytest
import torch

from benchmark import reference, scenes, weights
from benchmark.manifest import cell, port_config

F64 = reference.Numerics(stack=torch.float64)


def _config(name):
    return dict(cell(name).config, height=64, width=96, batch=2, precision="f32")


def _port(conf, state_dict):
    from monodepth_tpu_torch.models.monodepth import Monodepth

    model = Monodepth(num_layers=conf["num_layers"], scales=tuple(conf["scales"]))
    model.load_state_dict(state_dict)
    return model.double()


def _inputs(conf, seed, steps):
    g = scenes.generator(seed, 1, "cpu")
    H, W, B = conf["height"], conf["width"], conf["batch"]
    ring = scenes.planar_scenes(g, steps * B, H, W, 14.0, 4, "cpu")
    f64 = lambda v: v.double() if v.dtype.is_floating_point else v  # noqa: E731
    batches = [{k: f64(v[i * B:(i + 1) * B]) for k, v in ring.items()} for i in range(steps)]
    noises = [{s: v.double() for s, v in scenes.tie_noise(g, B, H, W, 2, conf["scales"],
                                                          "cpu").items()}
              for _ in range(steps)]
    return batches, noises


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@pytest.mark.parametrize("name", ["r18_mono_640x192.train", "r50_mono_640x192.train"])
def test_train_steps_match_the_port(name, few_threads):
    from monodepth_tpu_torch.training.state import create_state
    from monodepth_tpu_torch.training.step import make_train_step

    conf = _config(name)
    sd = weights.seeded_state_dict(conf, scenes.generator(3, 0, "cpu"), "cpu")
    batches, noises = _inputs(conf, 3, 2)

    model = _port(conf, sd)
    cfg = dataclasses.replace(port_config(conf))
    state = create_state(cfg, model, steps_per_epoch=1000)
    step = make_train_step(model, cfg, device="cpu", graph=False)
    disps = []
    hook = model.decoder.register_forward_hook(
        lambda module, args, out: disps.append(out[0].detach().clone()))
    losses, grads = [], []
    for batch, noise in zip(batches, noises):
        losses.append(float(step(state, batch, noise)["loss"]))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        hook.remove()

    ref = reference.build(conf, F64)
    ref.load_state_dict(sd)
    traj = reference.train_steps(ref.double(), conf, batches, noises, conf["learning_rate"])

    for ours, theirs in zip(losses, traj.losses):
        assert abs(ours - theirs) <= 1e-12 * abs(theirs)
    assert _rel(disps[0], traj.disp1) < 1e-12
    assert max(_rel(grads[0][n], traj.grad1[n]) for n in grads[0]) < 1e-9
    # each leaf's change over the two steps: Adam's second update divides
    # gradients of opposite signs' sums, which scales the last bits up
    params = dict(model.named_parameters())
    assert max(_rel(params[n].detach() - sd[n].double(), traj.params[n] - sd[n].double())
               for n in params) < 1e-7
    # the second gradient is taken at the weights after the first update
    assert max(_rel(grads[1][n], traj.grad2[n]) for n in grads[1]) < 1e-7
    buffers = dict(model.named_buffers())
    # the second step's statistics see the weights after that amplified update
    assert max(_rel(buffers[n], traj.stats[n]) for n in traj.stats) < 1e-9
