"""The port's multi-device layer (`monodepth_tpu_torch.parallel`): mesh
shapes and errors, the batch layout, and the spatial warp in 4 gloo
processes against JAX's `_spatial_pallas_sampler` on the virtual-device
mesh (Pallas kernel in interpret mode), as tests/test_parallel.py holds
the JAX layer. The steps under a mesh are in test_torch_parallel_steps.py."""

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
from monodepth_tpu_torch.ops.cuda.warp_sample import warp_sample_reference
from monodepth_tpu_torch.parallel import init_distributed, make_mesh, replicate
from monodepth_tpu_torch.parallel.mesh import Mesh, mesh_shape, shard_batch, warm_collectives
from test_torch_warp_sample import _warp_grid_np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_mesh_shapes():
    """As JAX's make_mesh over 8 devices: data=0 takes the rest, too many
    raises; the port also refuses a mesh that leaves processes out."""
    assert mesh_shape(8) == (8, 1)
    assert mesh_shape(8, 4, 2) == (4, 2)
    assert mesh_shape(8, 0, 4) == (2, 4)
    for data, spatial, match in ((16, 1, "needs 16 devices"),
                                 (0, 3, "not divisible"),
                                 (2, 2, "leaves 4 of 8")):
        with pytest.raises(ValueError, match=match):
            mesh_shape(8, data, spatial)


def test_single_process_mesh():
    """Without a process group: a 1x1 mesh on the named device, and the
    group calls are no-ops."""
    assert init_distributed("cpu") is False
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "spatial": 1}
    assert (mesh.rank, mesh.data_group, mesh.spatial_group) == (0, None, None)
    assert warm_collectives(mesh) == 1.0
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(2, device="cpu")
    state = object()
    assert replicate(mesh, state) is state


def _host_batch(B=8, H=32, W=64, F=3):
    rng = np.random.default_rng(0)
    return {"frames": rng.integers(0, 255, (B, F, H, W, 3), dtype=np.uint8),
            "jitter": rng.uniform(size=(B, 5)).astype(np.float32),
            "depth_gt": rng.uniform(size=(B, 375, 1242)).astype(np.float32)}


def test_batch_layout_on_mesh():
    """As JAX's `batch_sharding` on a {data: 4, spatial: 2} mesh: frames
    over B and H, depth_gt over B only; the pieces of all ranks tile the
    batch in rank order (rank = data_index · spatial + spatial_index)."""
    batch = _host_batch()
    pieces = [shard_batch(Mesh(4, 2, r, torch.device("cpu")), batch) for r in range(8)]
    assert pieces[0]["frames"].shape == (2, 3, 16, 64, 3)
    assert pieces[0]["depth_gt"].shape == (2, 375, 1242)
    assert pieces[0]["jitter"].shape == (2, 5)
    assert all(p["frames"].is_contiguous() for p in pieces)
    rows = [torch.cat([pieces[d * 2 + s]["frames"] for s in range(2)], 2)
            for d in range(4)]
    assert torch.equal(torch.cat(rows, 0), torch.from_numpy(batch["frames"]))
    for key in ("depth_gt", "jitter"):
        assert torch.equal(torch.cat([pieces[d * 2][key] for d in range(4)], 0),
                           torch.from_numpy(batch[key]))
        assert torch.equal(pieces[1][key], pieces[0][key])  # spatial ranks alike
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(3, 1, 0, torch.device("cpu")), batch)


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """JAX's spatial sampler and the port's (4 gloo processes), both on a
    {data: 2, spatial: 2} mesh, 32x128, batch 4, halo 8, on one smooth
    field (taps within 2 px: K3's path) and one wild (uniform, taps
    anywhere: the fallback) -> {field: (img, grid, jax out, jax dgrid,
    port results stitched)}."""
    rng = np.random.default_rng(0)
    B, H, W = 4, 32, 128
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    fields = {"smooth": _warp_grid_np(rng, B, H, W, wild_entry=False),
              "wild": rng.uniform(-1.5, 1.5, (B, H, W, 2)).astype(np.float32)}

    cfg = JConfig(height=H, width=W, batch=B, precision="f32", scales=(0, 1),
                  weight_init=False, use_pallas=True, pallas_interpret=True,
                  spatial_halo=8)
    mesh = jmake_mesh(2, 2)
    sampler = jax.jit(_spatial_pallas_sampler(cfg, mesh, interpret=True))
    sh = NamedSharding(mesh, P("data", "spatial"))
    img_s = jax.device_put(img, sh)
    theirs = {}
    for name, grid in fields.items():
        grid_s = jax.device_put(grid, sh)
        out = np.asarray(sampler(img_s, grid_s))
        dgrid = np.asarray(jax.grad(lambda g: (sampler(img_s, g) ** 2).sum())(grid_s))
        theirs[name] = (out, dgrid)

    tmp = tmp_path_factory.mktemp("spatial")
    np.savez(tmp / "inputs.npz", img=img, fields=np.array(list(fields)), **fields)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    done = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_spatial_worker.py"),
                           str(tmp / "inputs.npz"), str(tmp)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr[-3000:]
    ranks = [np.load(tmp / f"rank{r}.npz") for r in range(4)]

    def stitch(key):  # rank = data_index * 2 + spatial_index
        return np.concatenate([np.concatenate([ranks[d * 2 + s][key] for s in range(2)], 1)
                               for d in range(2)], 0)

    return {name: (img, fields[name], *theirs[name],
                   {k: stitch(f"{name}_{k}") for k in ("out", "dgrid", "eval")},
                   [int(r[f"{name}_fallbacks"]) for r in ranks])
            for name in fields}


@pytest.mark.parametrize("field", ["smooth", "wild"])
def test_spatial_sampler_matches_jax(spatial_runs, field):
    """Output atol 2e-6, dgrid atol 5e-6·scale against JAX's sampler."""
    _, _, out, dgrid, ours, _ = spatial_runs[field]
    np.testing.assert_allclose(ours["out"], out, atol=2e-6)
    scale = max(float(np.abs(dgrid).max()), 1.0)
    np.testing.assert_allclose(ours["dgrid"], dgrid, atol=5e-6 * scale)


@pytest.mark.parametrize("field", ["smooth", "wild"])
def test_spatial_sampler_is_the_global_warp(spatial_runs, field):
    """Either branch gives the global warp bit for bit, in both forms."""
    img, grid, _, _, ours, _ = spatial_runs[field]
    whole = warp_sample_reference(torch.from_numpy(img), torch.from_numpy(grid)).numpy()
    assert np.array_equal(ours["out"], whole)
    assert np.array_equal(ours["eval"], whole)


def test_spatial_sampler_branches(spatial_runs):
    """The smooth field stays in every slab (K3 on all ranks, 0
    fallbacks); the wild one sends every rank of each spatial group to the
    fallback together, in the train and the eval form."""
    assert spatial_runs["smooth"][-1] == [0, 0, 0, 0]
    assert spatial_runs["wild"][-1] == [2, 2, 2, 2]
