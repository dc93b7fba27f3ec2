"""The spatial mesh's row primitives (`monodepth_tpu_torch.parallel.rows`
and the ops that call it) against their whole-image ops, in float64 on
the CPU: one spawn of 3 gloo ranks (`tests/torch_rows_worker.py`, one
thread a rank), so the middle rank has two neighbours. Each case runs on
each rank's rows, forward and backward through the differentiable halo
exchange, and here on the whole image with the same function and inputs:
the convolutions 7x7/s2, 3x3/s1, 3x3/s2 and 1x1/s2, the max pool, the
reflection pad with a 3x3 conv, the bilinear resize x2, x4 and x8, SSIM,
the smoothness loss, the contrast jitter, the global means, the depth
network (ResNet-18 encoder and decoder in eval mode) at 96 rows, and the
level rule (a level gathered to run whole and split back into a skip
concat, and PoseCNN at 48 rows, which gathers at its 3-row level). The
stitched outputs and input gradients hold to max |diff| <= 1e-12. And
synced batch norm (`models/resnet.py` `_SyncedNorm`) equals the plain
autograd composition of the same ops bit for bit, f32 and bf16, on every
rank."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_rows_worker as worker
from monodepth_tpu_torch.parallel import rows
from torch_parity import one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results. The spawn's deadline (600 s) guards against a
    hung rank on a host shared with other test workers."""
    tmp = tmp_path_factory.mktemp("rows")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_rows_worker.py"),
                           str(tmp)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=660)
    assert done.returncode == 0, done.stderr[-3000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(worker.N)]


def _whole(name):
    """(outputs, {input: gradient}) of the case on the whole image."""
    fn, _, kind, _, _ = worker.CASES[name]
    mods = worker.modules()
    inputs = {k: t.clone().requires_grad_(True) for k, (t, _) in worker.inputs(name).items()}
    outs = worker.as_list(fn(mods, *inputs.values()))
    loss = 0.0
    for k, out in enumerate(outs):
        if kind == "rows":
            loss = loss + (out * worker.cotangent(name, k, out.shape)).sum()
        elif kind == "whole":
            weight = sum(worker.cotangent(name, k, out.shape, r) for r in range(worker.N))
            loss = loss + (out * weight).sum()
        else:
            loss = loss + out
    loss.backward()
    return [o.detach().numpy() for o in outs], {k: t.grad.numpy() for k, t in inputs.items()}


@pytest.mark.parametrize("name", list(worker.CASES))
def test_rows_match_the_whole_image(ranks, name):
    _, specs, kind, _, out_axis = worker.CASES[name]
    outs, grads = _whole(name)
    for k, want in enumerate(outs):
        got = [r[f"{name}/out{k}"] for r in ranks]
        if kind == "rows":
            got = np.concatenate(got, out_axis)
        elif kind == "part":
            got = sum(got)
        else:  # every rank holds the whole value
            for g in got[1:]:
                np.testing.assert_array_equal(g, got[0])
            got = got[0]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12, (name, k, np.abs(got - want).max())
    for key, (_, axis) in specs.items():
        got = [r[f"{name}/grad_{key}"] for r in ranks]
        # a replicated input's gradient is the sum of the ranks' parts
        got = sum(got) if axis is None else np.concatenate(got, axis)
        assert np.abs(got - grads[key]).max() <= 1e-12, \
            (name, key, np.abs(got - grads[key]).max())
        assert np.abs(grads[key]).max() > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_synced_norm_is_autograd_bit_for_bit(ranks, dtype):
    """Synced batch norm's own backward (it keeps the input in its dtype)
    gives autograd's bits, on each of the 3 ranks."""
    for r in ranks:
        for key in ("out", "grad_x", "grad_w", "grad_b"):
            mine, plain = (r[f"synced_norm/{dtype}/{how}/{key}"]
                           for how in ("module", "autograd"))
            np.testing.assert_array_equal(mine, plain, err_msg=f"{dtype} {key}")
            assert np.abs(plain).max() > 0


def test_level_rule():
    """The rule's levels at the shapes the tests and the card run, and
    whole everywhere without a spatial mesh."""
    from monodepth_tpu_torch.parallel.mesh import Mesh

    def levels(n, height, fn=rows.resnet_levels):
        with rows.row_sharding(Mesh(1, n, 0, torch.device("cpu")), height):
            return fn()

    assert rows.resnet_levels() == [False] * 6
    assert levels(2, 32) == [True] * 5 + [False]  # layer4: 1 row
    assert levels(2, 192) == [True] * 6  # 96/48/24/12/6 rows -> 48/24/12/6/3
    assert levels(3, 96) == [True] * 6
    assert levels(4, 32) == [True] * 4 + [False] * 2
    assert levels(8, 32) == [True] * 3 + [False] * 3  # scale 3 (4 rows) whole
    kernels = [k for _, k in worker.PoseCNN.SPECS]
    # PoseCNN 192 -> 96 -> ... -> 6 -> 3 -> 2 rows: at n = 2 it gathers at 3
    assert levels(2, 192, lambda: rows.posecnn_levels(kernels)) == [True] * 6 + [False] * 2
