"""--remat in the port: one float64 train step with `remat=True` against
the same step without, from deep copies of one state on one batch and one
noise. Recomputing the residual blocks and the warps changes no value
(loss rel < 1e-12, gradients < 1e-10 of their scale), and batch norm counts
each batch once: the running statistics equal the step without remat, and
`num_batches_tracked` is 1 after one step (the pose encoder's 2: it runs
once per source frame). The warp runs twice per warp
under remat (8 warps a step, 16 sampler calls). On a {data: 2, spatial: 2}
gloo mesh in f64 a remat run equals the run without."""

import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.models.resnet import BatchNorm2d
from monodepth_tpu_torch.ops.cuda.warp_sample import WarpSample
from monodepth_tpu_torch.ops.sampling import grid_sample
from monodepth_tpu_torch.training.state import MODULES, build_model, create_state, module_grads
from monodepth_tpu_torch.training.step import make_train_step
from torch_parity import one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(height=32, width=64, batch=2, scales=(0, 1, 2, 3), precision="f32",
          weight_init=False)


def _batch(cfg):
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=3, tx_sign=1.0)
    jitter = np.tile(np.array([1, 1.1, 0.9, 1.05, 0.02]), (cfg.batch, 1))
    return {"frames": scenes["frames"], "jitter": jitter,
            "K": scenes["K"].astype(np.float64), "inv_K": scenes["inv_K"].astype(np.float64)}


def _noise(cfg):
    g = torch.Generator().manual_seed(11)
    shape = (cfg.batch, cfg.height, cfg.width, len(cfg.source_frame_ids))
    return {s: 1e-5 * torch.randn(shape, generator=g, dtype=torch.float64)
            for s in cfg.scales}


def _step(cfg, state, sampler):
    """One train step with `cfg` on `state`; -> (loss, sampler calls)."""
    calls = []

    def counted(image, grid):
        calls.append(1)
        return sampler(image, grid)

    metrics = make_train_step(state.model, cfg, device="cpu", sampler=counted)(
        state, _batch(cfg), noise=_noise(cfg))
    return float(metrics["loss"]), len(calls)


@pytest.fixture(scope="module", params=["WarpSample", "grid_sample"])
def pair(request):
    """(cfg, state without remat, state with remat, loss and sampler calls
    of each) after one f64 step from one init."""
    sampler = WarpSample.apply if request.param == "WarpSample" else grid_sample
    cfg = Config(**KW)
    model = build_model(cfg, device="cpu").double()
    model.encoder.bn1.running_mean.uniform_(-0.1, 0.1)  # non-trivial start
    base = create_state(cfg, model, steps_per_epoch=10)
    remat_cfg = dataclasses.replace(cfg, remat=True)
    states = {False: copy.deepcopy(base), True: copy.deepcopy(base)}
    for remat, state in states.items():
        for enc in (state.model.encoder, state.model.pose_encoder):
            enc.remat = remat
    plain = _step(cfg, states[False], sampler)
    remat = _step(remat_cfg, states[True], sampler)
    return cfg, states[False], states[True], plain, remat


def test_remat_step_loss_equals(pair):
    _, _, _, (loss, _), (remat_loss, _) = pair
    assert abs(remat_loss - loss) / abs(loss) < 1e-12, (remat_loss, loss)


@pytest.mark.parametrize("module", MODULES)
def test_remat_step_grads_equal(pair, module):
    _, plain, remat, *_ = pair
    a, b = module_grads(remat.model)[module], module_grads(plain.model)[module]
    assert a.dtype == torch.float64
    scale = float(b.abs().max())
    assert scale > 0 and float((a - b).abs().max()) / scale < 1e-10


def test_remat_step_updates_batch_norm_once(pair):
    cfg, plain, remat, *_ = pair
    ours = dict(remat.model.named_buffers())
    theirs = dict(plain.model.named_buffers())
    assert set(ours) == set(theirs)
    for name, buf in theirs.items():
        if name.endswith("num_batches_tracked"):
            # the pose encoder runs once per source frame
            runs = 1 if name.startswith("encoder.") else len(cfg.source_frame_ids)
            assert int(ours[name]) == int(buf) == runs, name
        else:
            np.testing.assert_allclose(ours[name].numpy(), buf.numpy(),
                                       rtol=1e-12, atol=1e-14, err_msg=name)
    assert not any(m.keep_stats for m in remat.model.modules()
                   if isinstance(m, BatchNorm2d))


def test_remat_recomputes_each_warp(pair):
    *_, (_, calls), (_, remat_calls) = pair
    assert calls == 8 and remat_calls == 16


def test_remat_is_off_without_autograd(pair):
    """Without autograd a remat model runs no checkpoint and gives the same
    disparities."""
    cfg, plain, remat, *_ = pair
    remat.model.load_state_dict(plain.model.state_dict())
    images = torch.from_numpy(_batch(cfg)["frames"][:, 0] / 255.0)
    with torch.no_grad():
        a, b = (s.model.eval().depth(images)[0] for s in (plain, remat))
    assert torch.equal(a, b)


def test_build_model_hands_remat_to_both_encoders():
    model = build_model(Config(**KW, remat=True), device="cpu")
    assert model.encoder.remat and model.pose_encoder.remat
    assert not build_model(Config(**KW), device="cpu").encoder.remat


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{remat: rank 0's report} of `run_steps` on a {data: 2, spatial: 2}
    mesh in f64 (4 gloo processes each at one thread, both runs at once), with and
    without --remat, each with the one-device reference. The deadline is
    a guard against a hung rank, wide enough for a host shared with five
    other test workers (as `tests/test_torch_parallel_steps.py`)."""
    tmp = tmp_path_factory.mktemp("remat_mesh")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = {}
    for remat in (False, True):
        out = tmp / f"remat_{remat}"
        cmd = [sys.executable, "-m", "monodepth_tpu_torch.parallel.run_steps",
               "--data", "2", "--spatial", "2", "--device", "cpu", "--spawn",
               "--reference", "--f64", "--steps", "2", "--threads", "1", "--timeout", "60",
               "--deadline", "600", "--out", str(out), "--height", "32", "--width", "128",
               "--batch", "4", "--precision", "f32", "--remat", str(remat).lower()]
        procs[remat] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True), out)
    reports = {}
    try:
        for remat, (proc, out) in procs.items():
            _, err = proc.communicate(timeout=660)
            assert proc.returncode == 0, (remat, err[-3000:])
            reports[remat] = json.loads((out / "rank0.json").read_text())
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return reports


def test_remat_on_a_mesh(mesh_runs):
    """Under `sync_batch_stats` the recomputation normalizes over the same
    group (it runs in the backward, outside the forward's context): the
    remat mesh equals its one-device reference and the mesh without remat,
    and each rank's 16 train-form slab warps run twice."""
    plain, remat = mesh_runs[False], mesh_runs[True]
    ref = remat["reference"]
    assert max(ref["loss_rel"]) <= 1e-10 and max(ref["grad_rel_l2"].values()) <= 1e-9
    assert ref["param_max_abs"] <= 1e-9 and ref["bn_stats_max_abs"] <= 1e-12
    for a, b in zip(remat["losses"], plain["losses"]):
        assert abs(a - b) / abs(b) < 1e-12
    assert abs(remat["param_checksum"] - plain["param_checksum"]) <= \
        1e-12 * abs(plain["param_checksum"])
    assert (plain["slab_warps"], remat["slab_warps"]) == (24, 40)
