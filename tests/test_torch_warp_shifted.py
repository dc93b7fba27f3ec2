"""The shifted (row-slab) form of the port's warp, K3
(`warp_sample_shifted`, `warp_sample_grads_shifted`, `WarpSampleShifted`):
its plain version against JAX's `warp_sample_shifted` (Pallas kernel in
interpret mode) shard by shard, as tests/test_pallas.py holds the JAX
slab form to the global warp; the stitched shards against the port's
global warp exactly; the slab's (absent) gradient; and `grid_vjp` over a
full height that differs from the grid's. The CUDA kernel against its
plain version is in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu.ops.pallas.warp_sample import _forward as jax_forward
from monodepth_tpu.ops.pallas.warp_sample import warp_sample_shifted as jax_shifted
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    WarpSample,
    WarpSampleShifted,
    grid_vjp,
    warp_sample_grads_reference,
    warp_sample_grads_shifted,
    warp_sample_grads_shifted_reference,
    warp_sample_reference,
    warp_sample_shifted,
    warp_sample_shifted_reference,
)
from test_torch_warp_sample import _warp_grid_np

B, H, W, C = 2, 32, 128, 3
N, HALO = 2, 8
HL = H // N


def _slab(img, s, halo=HALO):
    """Shard s's slab as the halo exchange delivers it: its rows plus
    `halo` rows of each neighbour, zeros beyond the image -> (slab, row0)."""
    lo, hi = s * HL - halo, (s + 1) * HL + halo
    ext = np.zeros((img.shape[0], HL + 2 * halo) + img.shape[2:], img.dtype)
    src_lo, src_hi = max(lo, 0), min(hi, H)
    ext[:, src_lo - lo:src_hi - lo] = img[:, src_lo:src_hi]
    return ext, lo


@pytest.fixture
def case(rng):
    img = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    return img, _warp_grid_np(rng, B, H, W, wild_entry=False)


def _dgrid_port(ext, gslab, row0):
    g = torch.from_numpy(gslab).requires_grad_(True)
    out = WarpSampleShifted.apply(torch.from_numpy(ext), g, row0, H)
    (out ** 2).sum().backward()
    return g.grad.numpy()


@pytest.mark.parametrize("s", range(N))
def test_shifted_reference_matches_jax_per_shard(case, s):
    """Forward atol 1e-6 and dgrid atol 3e-6·scale against JAX's slab
    warp on the same slab, at both shards (row0 negative on the first)."""
    img, grid = case
    ext, row0 = _slab(img, s)
    gslab = grid[:, s * HL:(s + 1) * HL]
    ours = warp_sample_shifted_reference(torch.from_numpy(ext),
                                         torch.from_numpy(gslab), row0, H)
    theirs = jax_shifted(jnp.asarray(ext), jnp.asarray(gslab),
                         jnp.float32(row0), H, True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-6)
    dtheirs = jax.grad(lambda g: (jax_shifted(jnp.asarray(ext), g, jnp.float32(row0),
                                              H, True) ** 2).sum())(jnp.asarray(gslab))
    scale = max(float(jnp.abs(dtheirs).max()), 1.0)
    np.testing.assert_allclose(_dgrid_port(ext, gslab, row0), np.asarray(dtheirs),
                               atol=3e-6 * scale)


def test_shifted_train_form_matches_jax_kernel(rng):
    """(out, gx, gy) of the train form against the Pallas kernel's shifted
    `with_grads=True` launch, on a wild field whose anchors leave the slab:
    both clamp them to the slab's edge rows the same way."""
    img = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.5, 1.5, (B, HL, W, 2)).astype(np.float32)
    ext, row0 = _slab(img, 1)
    ours = warp_sample_grads_shifted_reference(torch.from_numpy(ext),
                                               torch.from_numpy(grid), row0, H)
    out, gx, gy = jax_forward(jnp.asarray(ext), jnp.asarray(grid),
                              jnp.float32(row0), H, interpret=True)
    theirs = [np.asarray(out)] + [np.asarray(t).transpose(0, 2, 3, 1) for t in (gx, gy)]
    for name, a, b in zip(("out", "gx", "gy"), ours, theirs):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, err_msg=name)


def test_stitched_shards_equal_global_warp(case):
    """Where every tap lies in its slab, the shards' outputs and tap
    differences stitch to the global warp's bit for bit, and the dgrid
    (grid_vjp over the full height) too."""
    img, grid = case
    outs, dgrids = [], []
    for s in range(N):
        ext, row0 = _slab(img, s)
        gslab = grid[:, s * HL:(s + 1) * HL]
        outs.append([t.numpy() for t in warp_sample_grads_shifted_reference(
            torch.from_numpy(ext), torch.from_numpy(gslab), row0, H)])
        dgrids.append(_dgrid_port(ext, gslab, row0))
    whole = warp_sample_grads_reference(torch.from_numpy(img), torch.from_numpy(grid))
    for i, name in enumerate(("out", "gx", "gy")):
        stitched = np.concatenate([o[i] for o in outs], 1)
        assert np.array_equal(stitched, whole[i].numpy()), name
    g = torch.from_numpy(grid).requires_grad_(True)
    (WarpSample.apply(torch.from_numpy(img), g, True) ** 2).sum().backward()
    assert np.array_equal(np.concatenate(dgrids, 1), g.grad.numpy())
    eval_form = [warp_sample_shifted_reference(torch.from_numpy(_slab(img, s)[0]),
                                               torch.from_numpy(grid[:, s * HL:(s + 1) * HL]),
                                               _slab(img, s)[1], H).numpy()
                 for s in range(N)]
    assert np.array_equal(np.concatenate(eval_form, 1),
                          warp_sample_reference(torch.from_numpy(img),
                                                torch.from_numpy(grid)).numpy())


def test_slab_gets_no_gradient(case):
    """JAX's contract (test_pallas.py, the slab's cotangent is zero): the
    slab gets no gradient, the grid its full one."""
    img, grid = case
    ext, row0 = _slab(img, 0)
    slab = torch.from_numpy(ext).requires_grad_(True)
    g = torch.from_numpy(grid[:, :HL]).requires_grad_(True)
    WarpSampleShifted.apply(slab, g, row0, H).sum().backward()
    assert slab.grad is None
    assert g.grad is not None and g.grad.shape == g.shape
    assert float(g.grad.abs().max()) > 0


def test_grid_vjp_takes_the_full_height(rng):
    """A slab's y coordinate is normalized over the full height, so its
    clip slope is 0.5·(full_height - 1), not 0.5·(Hout - 1): grid_vjp of a
    slab of rows equals the global dgrid's rows only with full_height."""
    img, grid = (rng.uniform(size=(1, H, W, C)).astype(np.float32),
                 _warp_grid_np(rng, 1, H, W, wild_entry=False))
    dout = torch.from_numpy(rng.standard_normal((1, HL, W, C)).astype(np.float32))
    ext, row0 = _slab(img, 1)
    gslab = torch.from_numpy(grid[:, HL:])
    _, gx, gy = warp_sample_grads_shifted_reference(torch.from_numpy(ext), gslab, row0, H)
    full = grid_vjp(gslab, dout, gx, gy, H)
    short = grid_vjp(gslab, dout, gx, gy, HL)
    # the x column does not depend on the height; the y column scales by
    # (H - 1) / (HL - 1) wherever the coordinate is inside
    assert torch.equal(full[..., 0], short[..., 0])
    ratio = (full[..., 1] / short[..., 1])[short[..., 1] != 0]
    np.testing.assert_allclose(ratio.numpy(), (H - 1) / (HL - 1), rtol=1e-6)
    # against jax.grad of the JAX slab warp, with dout as the cotangent
    _, vjp = jax.vjp(lambda g: jax_shifted(jnp.asarray(ext), g, jnp.float32(row0),
                                           H, True), jnp.asarray(grid[:, HL:]))
    (theirs,) = vjp(jnp.asarray(dout.numpy()))
    scale = max(float(jnp.abs(theirs).max()), 1.0)
    np.testing.assert_allclose(full.numpy(), np.asarray(theirs), atol=3e-6 * scale)


def test_same_size_callers_keep_their_gradient(case):
    """WarpSample passes the grid's own height: its dgrid is unchanged by
    the explicit `full_height` (against `torch.autograd` through the plain
    grid_sample, as before)."""
    img, grid = case
    g = torch.from_numpy(grid).requires_grad_(True)
    (WarpSample.apply(torch.from_numpy(img), g, True) ** 2).sum().backward()
    _, gx, gy = warp_sample_grads_reference(torch.from_numpy(img), torch.from_numpy(grid))
    out = warp_sample_reference(torch.from_numpy(img), torch.from_numpy(grid))
    assert torch.equal(g.grad, grid_vjp(torch.from_numpy(grid), 2 * out, gx, gy, H))


def test_nan_coordinate_poisons_only_its_pixel(case):
    img, grid = case
    grid = grid.copy()
    grid[0, HL + 3, 5] = np.nan
    grid[1, HL + 4, 6, 1] = np.inf
    ext, row0 = _slab(img, 1)
    out = warp_sample_shifted_reference(torch.from_numpy(ext),
                                        torch.from_numpy(grid[:, HL:]), row0, H)
    nan = out.isnan().any(-1)
    assert int(nan.sum()) == 1 and bool(nan[0, 3, 5])


def test_cpu_wrappers_run_the_plain_version(case):
    """On CPU tensors the wrappers take the plain version and count no
    launch."""
    img, grid = case
    ext, row0 = _slab(img, 1)
    args = (torch.from_numpy(ext), torch.from_numpy(grid[:, HL:]), row0, H)
    before = warp_sample_shifted.launches, warp_sample_grads_shifted.launches
    assert torch.equal(warp_sample_shifted(*args), warp_sample_shifted_reference(*args))
    for a, b in zip(warp_sample_grads_shifted(*args),
                    warp_sample_grads_shifted_reference(*args)):
        assert torch.equal(a, b)
    assert (warp_sample_shifted.launches, warp_sample_grads_shifted.launches) == before


@pytest.mark.parametrize("image_shape,grid_shape,row0,full_height,error", [
    ((2, 24, 128, 3), (2, 16, 64, 2), 0, 32, ValueError),     # width differs
    ((2, 24, 128, 3), (1, 16, 128, 2), 0, 32, ValueError),    # batch differs
    ((2, 1, 128, 3), (2, 16, 128, 2), 0, 32, ValueError),     # 1-row slab
    ((2, 24, 128, 3), (2, 16, 128, 2), 0, 1, ValueError),     # 1-row image
    ((2, 24, 128, 3), (2, 16, 128), 0, 32, ValueError),       # grid rank
    ((2, 24, 128, 3), (2, 16, 128, 2), 0.5, 32, TypeError),   # row0 not int
])
def test_shifted_shape_checks(image_shape, grid_shape, row0, full_height, error):
    image, grid = torch.zeros(image_shape), torch.zeros(grid_shape)
    for fn in (warp_sample_shifted, warp_sample_grads_shifted):
        with pytest.raises(error):
            fn(image, grid, row0, full_height)
