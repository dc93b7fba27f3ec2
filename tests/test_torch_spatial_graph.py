"""The spatial warp in both forms (`training/step.py` `_spatial_sampler`):
the eager steps' host branch between K3 on the rank's halo slab
(`local_warp`) and K3 on the group's gathered rows (`spatial_fallback`),
and the captured steps' `gather` form, every warp on the gathered rows.
On the CPU:

- both forms on gloo `{spatial: 2}` and `{spatial: 3}` meshes
  (`tests/torch_spatial_worker.py`) against JAX's `_spatial_pallas_sampler`
  on the virtual-device mesh (Pallas in interpret mode), 48x128, batch 2,
  halo 8, on a smooth field (every tap in its slab), a wild one (taps
  anywhere) and a mixed one (smooth but for a few pixels of the first
  rank's rows that read the bottom rows: that rank's own check fails, and
  the group's agreed flag sends every rank to the exact warp): out atol
  2e-6 and the grid's gradient atol 1e-6 · max(scale, 1), in the train
  form, and the eval form equal to the train form's out;
- the gather form equal to the branch bit for bit (what lets a captured
  step equal the eager one), and each rank's warps counted by the path
  it took;
- K3 on the gathered image at a rank's rows equal to those rows of the
  whole image's warp, and the counters a graph replay advances (the
  capture itself is `tests/test_torch_gpu.py`'s)."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.parallel import make_mesh as jmake_mesh
from monodepth_tpu.training.step import _spatial_pallas_sampler
from monodepth_tpu_torch.ops.cuda import photometric as ph
from monodepth_tpu_torch.ops.cuda import warp_sample as ws
from monodepth_tpu_torch.training.graphs import COUNTED
from monodepth_tpu_torch.training.phases import mark
from monodepth_tpu_torch.training.step import local_warp, spatial_fallback
from test_torch_warp_sample import _warp_grid_np

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, W, HALO = 2, 48, 128, 8
FORMS = ("", "_gather")  # the branch, the captured steps' gather


def _fields(rng):
    smooth = _warp_grid_np(rng, B, H, W, wild_entry=False)
    mixed = smooth.copy()
    mixed[0, 2, 5:9, 1] = 1.0  # rows of the first rank read the last rows
    return {"smooth": smooth,
            "wild": rng.uniform(-1.5, 1.5, (B, H, W, 2)).astype(np.float32),
            "mixed": mixed}


@pytest.fixture(scope="module", params=[2, 3], ids=["spatial2", "spatial3"])
def runs(request, tmp_path_factory):
    """{field: (JAX out, JAX dgrid, {form: the port's ranks stitched by
    rows, with [(slab warps, exact warps) of each rank]})} on a
    {spatial: n} mesh; forms "" (the branch) and "_gather"."""
    n = request.param
    rng = np.random.default_rng(n)
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    fields = _fields(rng)
    cfg = JConfig(height=H, width=W, batch=B, precision="f32", scales=(0, 1),
                  weight_init=False, use_pallas=True, pallas_interpret=True,
                  spatial_halo=HALO)
    mesh = jmake_mesh(1, n)
    sampler = jax.jit(_spatial_pallas_sampler(cfg, mesh, interpret=True))
    sh = NamedSharding(mesh, P("data", "spatial"))
    img_s = jax.device_put(img, sh)
    theirs = {}
    for name, grid in fields.items():
        grid_s = jax.device_put(grid, sh)
        out = np.asarray(sampler(img_s, grid_s))
        dgrid = np.asarray(jax.grad(lambda g: (sampler(img_s, g) ** 2).sum())(grid_s))
        theirs[name] = (out, dgrid)

    tmp = tmp_path_factory.mktemp(f"spatial{n}")
    np.savez(tmp / "inputs.npz", img=img, fields=np.array(list(fields)), **fields)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_spatial_worker.py"),
                           str(tmp / "inputs.npz"), str(tmp), "1", str(n), str(HALO)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]
    return {name: (*theirs[name],
                   {form: {**{k: np.concatenate([r[f"{name}{form}_{k}"] for r in ranks], 1)
                              for k in ("out", "dgrid", "eval")},
                           "warps": [(int(r[f"{name}{form}_slab_warps"]),
                                      int(r[f"{name}{form}_fallbacks"])) for r in ranks]}
                    for form in FORMS})
            for name in fields}


@pytest.mark.parametrize("form", ["", "_gather"], ids=["branch", "gather"])
@pytest.mark.parametrize("field", ["smooth", "wild", "mixed"])
def test_spatial_warp_matches_jax(runs, field, form):
    """Out atol 2e-6 and the grid's gradient atol 1e-6 · max(scale, 1)
    against JAX's sampler; the eval form is the train form's out."""
    out, dgrid, ours = runs[field]
    ours = ours[form]
    np.testing.assert_allclose(ours["out"], out, atol=2e-6)
    scale = max(float(np.abs(dgrid).max()), 1.0)
    np.testing.assert_allclose(ours["dgrid"], dgrid, atol=1e-6 * scale)
    assert np.array_equal(ours["eval"], ours["out"])


@pytest.mark.parametrize("field", ["smooth", "wild", "mixed"])
def test_gather_form_equals_the_branch(runs, field):
    """The gather form's out, grid gradient and eval out equal the
    branch's bit for bit, whichever warp the branch took: K3 reads the
    same taps on the slab as on the gathered rows."""
    _, _, ours = runs[field]
    for key in ("out", "dgrid", "eval"):
        assert np.array_equal(ours["_gather"][key], ours[""][key]), key


def test_spatial_warp_paths(runs):
    """The branch warps the smooth field on every rank's slab, once a
    form, and the wild and the mixed fields exactly on every rank: in the
    mixed one the first rank's own check fails and the agreed flag takes
    the others along. The gather form warps every field exactly."""
    n = len(runs["smooth"][-1][""]["warps"])
    assert runs["smooth"][-1][""]["warps"] == [(2, 0)] * n
    assert runs["wild"][-1][""]["warps"] == [(0, 2)] * n
    assert runs["mixed"][-1][""]["warps"] == [(0, 2)] * n
    for field in ("smooth", "wild", "mixed"):
        assert runs[field][-1]["_gather"]["warps"] == [(0, 2)] * n


def test_k3_on_the_gathered_rows_is_the_whole_warp():
    """K3 on a whole image (row0 0) at a rank's grid rows, the exact warp's
    launch, equals those rows of the whole image's warp (K1's plain
    version), out, gx and gy."""
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(size=(2, 16, 24, 3)).astype(np.float32))
    grid = torch.from_numpy(_warp_grid_np(rng, 2, 16, 24))
    whole = ws.warp_sample_grads(img, grid)
    for s in range(4):
        rows = grid[:, 4 * s:4 * s + 4].contiguous()
        got = ws.warp_sample_grads_shifted(img, rows, 0, 16)
        for a, b in zip(got, whole):
            assert torch.equal(a, b[:, 4 * s:4 * s + 4])
        assert torch.equal(ws.warp_sample_shifted(img, rows, 0, 16), got[0])


def test_replays_advance_the_spatial_counters():
    """A graph replay advances every counter a capture can move: the
    kernel wrappers' launches (the warp's and the photometric term's), the
    phase marks' and the spatial warps' calls, each once."""
    assert set(COUNTED) == {
        (ws.warp_sample, "launches"), (ws.warp_sample_grads, "launches"),
        (ws.warp_sample_shifted, "launches"), (ws.warp_sample_grads_shifted, "launches"),
        (ws.grid_vjp, "launches"), (ph.identity_errors, "launches"),
        (ph.photometric_min, "launches"), (ph.photometric_min_grads, "launches"),
        (mark, "launches"), (local_warp, "calls"), (spatial_fallback, "calls")}
    assert len(COUNTED) == len(set(COUNTED))
