"""The train step's phases (`training/phases.py`) on the CPU: the
`torch.profiler` ranges of an eager step and the marks it asks for, in
the documented order (grad_sync only on a mesh, one set a step of a K-step
call); the boundary over the networks' outputs leaves the loss, every
gradient and the update bit for bit as they were; nothing is launched on
a CPU tensor; the marks of `csrc/phase_mark.cu` are `PHASES`, in order;
the Trainer's wait for each batch is a range. torch only, tiny shapes.
The marks inside a captured replay are checked on the card
(`tests/test_torch_gpu.py`, marked `gpu`)."""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.ops.cuda.build import CSRC_DIR
from monodepth_tpu_torch.parallel.mesh import make_mesh
from monodepth_tpu_torch.training import phases
from monodepth_tpu_torch.training import step as step_module
from monodepth_tpu_torch.training.loop import _waited
from monodepth_tpu_torch.training.state import build_model, create_state

SHAPE = dict(height=32, width=64, batch=2, precision="f32", weight_init=False)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, seed=0):
    """Planar scenes, frames (0, -1, 1); with "s", the +1 view again as the
    stereo frame, its baseline as `stereo_T`."""
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=seed)
    batch = {k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")}
    if "s" in cfg.frame_ids:
        batch["frames"] = scenes["frames"][:, [0, 1, 2, 2]]
        stereo_T = np.tile(np.eye(4, dtype=np.float32), (cfg.batch, 1, 1))
        stereo_T[:, 0, 3] = scenes["gt_tx"]
        batch["stereo_T"] = stereo_T
    return batch


def _state(cfg):
    torch.manual_seed(0)
    return create_state(cfg, build_model(cfg, device="cpu"), steps_per_epoch=10)


def _record_marks(monkeypatch):
    marks = []

    def record(name, device):
        assert device.type == "cpu"
        marks.append(name)

    monkeypatch.setattr(phases, "mark", record)
    monkeypatch.setattr(step_module, "mark", record)
    return marks


@pytest.mark.parametrize("case", ["one_device", "mesh", "two_steps_a_call"])
def test_eager_train_step_opens_the_phases_in_order(monkeypatch, case):
    cfg = Config(**SHAPE)
    state = _state(cfg)
    marks = _record_marks(monkeypatch)
    order = [p for p in phases.PHASES if case == "mesh" or p != "grad_sync"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if case == "two_steps_a_call":
            step_module.make_train_multi_step(state.model, cfg, device="cpu")(
                state, [_batch(cfg), _batch(cfg, 1)])
        else:
            mesh = make_mesh(1, 1, "cpu") if case == "mesh" else None
            step_module.make_train_step(state.model, cfg, device="cpu", mesh=mesh)(
                state, _batch(cfg))
    steps = 2 if case == "two_steps_a_call" else 1
    ranges = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
              if e.name.startswith("train_step/")]
    # networks_bwd runs inside loss_bwd's backward, end after the step
    expected = [f"train_step/{p}" for p in order if p not in ("networks_bwd", "end")]
    assert ranges == expected * steps
    assert marks == order * steps


@pytest.mark.parametrize("wiring", [dict(), dict(pose_type="posecnn", frame_ids=(0, -1, 1, "s"))])
def test_the_boundary_leaves_loss_and_gradients_bit_equal(monkeypatch, wiring):
    """The step with the boundary and with it taken out, from one state:
    the loss, every gradient and the state after Adam equal exactly."""
    cfg = Config(**SHAPE, **wiring)
    batch = _batch(cfg)
    runs = []
    for boundary in (True, False):
        if not boundary:
            monkeypatch.setattr(step_module, "backward_boundary", lambda outputs: outputs)
        state = _state(cfg)
        metrics = step_module.make_train_step(state.model, cfg, device="cpu")(state, batch)
        runs.append((metrics["loss"], [p.grad for p in state.model.parameters()],
                     state.model.state_dict()))
    (loss_a, grads_a, sd_a), (loss_b, grads_b, sd_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(a is not None and torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


def test_phase_launches_nothing_on_a_cpu_tensor(monkeypatch):
    def no_library():
        raise AssertionError("a CPU phase loaded the CUDA library")

    monkeypatch.setattr(phases, "_library", no_library)
    before = phases.mark.launches
    x = torch.ones(3, requires_grad=True)
    with phases.phase("decode", x):
        y, = phases.backward_boundary([x * 2])
    y.sum().backward()
    phases.mark("end", x.device)
    assert phases.mark.launches == before
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_backward_boundary_hands_gradients_on_unchanged():
    """Outputs equal their inputs; an output without a gradient gives
    its input none (no zero-fill); outside autograd nothing is wrapped."""
    a = torch.randn(2, 3, requires_grad=True)
    b = torch.randn(4, requires_grad=True)
    tree = ({0: a * 1, 1: a * 3}, {-1: (b * 1, b * 2)})
    out = phases.backward_boundary(tree)
    assert all(torch.equal(x, y) for x, y in zip(
        [out[0][0], out[0][1], *out[1][-1]], [tree[0][0], tree[0][1], *tree[1][-1]]))
    (out[0][1].sum() * 2).backward()
    assert torch.equal(a.grad, torch.full((2, 3), 6.0)) and b.grad is None
    with torch.no_grad():
        plain = (a * 1,)
        assert phases.backward_boundary(plain) is plain


def test_the_cuda_marks_are_the_phases_in_order():
    source = (CSRC_DIR / "phase_mark.cu").read_text()
    kernels = re.findall(r'extern "C" __global__ void phase_mark_(\w+)\(\) \{\}', source)
    cases = re.findall(r"case (\d+): phase_mark_(\w+)<<<1, 1, 0, s>>>\(\); break;", source)
    assert tuple(kernels) == phases.PHASES
    assert [(int(i), n) for i, n in cases] == list(enumerate(phases.PHASES))


def test_the_trainer_waits_for_each_batch_inside_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert list(_waited(iter([{"a": 1}, {"a": 2}, {"a": 3}]))) == [{"a": 1}, {"a": 2},
                                                                        {"a": 3}]
    # one range a batch and one for the end of the epoch
    assert sum(e.name == "trainer/wait_data" for e in prof.events()) == 4
