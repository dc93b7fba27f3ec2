"""The plain reference against the port's CPU path, both reached through
the configuration's family, in float64 at 64x96 and batch 2, for every
one-card cell of `BENCHMARK.json` and for its first configuration with
the stereo frame "s": two train steps' losses, the first step's gradients
and finest disparity, the parameters after Adam's second update and the
batch-norm running statistics. Both sides load one seeded state_dict and
take the same batches and noise."""

import pytest
import torch

from benchmark import families, scenes, weights
from benchmark.manifest import cell, manifest

ONE_CARD = [w["name"] for w in manifest()["workloads"] if w["chips"] == 1]
CASES = [(name, {}) for name in ONE_CARD] + [(ONE_CARD[0], {"frame_ids": [0, -1, 1, "s"]})]


def _f64(d):
    return {k: v.double() if v.dtype.is_floating_point else v for k, v in d.items()}


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@pytest.mark.parametrize("name,change", CASES,
                         ids=[n + ("_stereo" if c else "") for n, c in CASES])
def test_train_steps_match_the_port(name, change, few_threads):
    c = cell(name)
    family = families.load(c.family)
    conf = dict(c.config, height=64, width=96, batch=2, precision="f32", **change)
    sd = weights.seeded_state_dict(family, conf, scenes.generator(3, 0, "cpu"), "cpu")
    batches, noises = family.inputs(conf, dict(c.traffic, ring=2), 3, 2, "cpu")
    batches, noises = [_f64(b) for b in batches], [_f64(n) for n in noises]

    state, step = family.port(conf, sd, "cpu", None, 1000)
    model = state.model.double()
    disps = []
    hook = family.disparity_module(model).register_forward_hook(
        lambda module, args, out: disps.append(out[0].detach().clone()))
    losses, grads = [], []
    for batch, noise in zip(batches, noises):
        losses.append(float(step(state, batch, noise)["loss"]))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        hook.remove()

    ref = family.reference.build(conf, family.reference.F64)
    ref.load_state_dict(sd)
    traj = family.reference.train_steps(ref.double(), conf, batches, noises,
                                        conf["learning_rate"])

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
