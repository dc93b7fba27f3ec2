"""The train form of the port's warp (`warp_sample_grads`, `WarpSample`):
its plain version against the JAX Pallas kernel's `with_grads=True` launch
in interpret mode, and the gradient with respect to the grid against
`jax.grad` through the JAX `warp_sample` and `grid_sample`. Plus the
`jnp.clip` tie rule of the port's `grid_sample` and SSIM (fault F1). The
CUDA kernel against its plain version is in tests/test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu.ops.pallas.warp_sample import _coords as jax_coords
from monodepth_tpu.ops.pallas.warp_sample import _forward as jax_forward
from monodepth_tpu.ops.pallas.warp_sample import warp_sample as jax_warp_sample
from monodepth_tpu.ops.sampling import grid_sample as jax_grid_sample
from monodepth_tpu.ops.ssim import ssim as jax_ssim
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    WarpSample,
    warp_sample_grads,
    warp_sample_grads_reference,
)
from monodepth_tpu_torch.ops.sampling import clip, grid_sample
from monodepth_tpu_torch.ops.ssim import ssim
from test_torch_warp_sample import _warp_grid_np


def _nhwc(a):
    return np.asarray(a).transpose(0, 2, 3, 1)


def _plain_vs_kernel(img, grid):
    """(port plain version, JAX Pallas kernel in interpret mode), each as
    (out, gx, gy) NHWC numpy arrays."""
    ours = warp_sample_grads_reference(torch.from_numpy(img),
                                       torch.from_numpy(grid))
    out, gx, gy = jax_forward(jnp.asarray(img), jnp.asarray(grid),
                              interpret=True, with_grads=True)
    return [t.numpy() for t in ours], [np.asarray(out), _nhwc(gx), _nhwc(gy)]


@pytest.mark.parametrize("B,H,W", [(2, 16, 256), (2, 16, 128)])
def test_grads_reference_matches_jax_kernel(rng, B, H, W):
    """Smooth field with one wild (out-of-bounds) batch entry."""
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    ours, theirs = _plain_vs_kernel(img, _warp_grid_np(rng, B, H, W))
    for name, a, b in zip(("out", "gx", "gy"), ours, theirs):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)


def test_grads_reference_nan_grid_matches_jax_kernel(rng):
    """NaN/inf coordinates: the same NaN pattern in out, gx and gy."""
    B, H, W = 1, 8, 128
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    grid = _warp_grid_np(rng, B, H, W, wild_entry=False)
    grid[0, 1, 2] = np.nan
    grid[0, 4, 5, 1] = np.inf
    ours, theirs = _plain_vs_kernel(img, grid)
    assert np.isnan(ours[0][0, 1, 2]).all()
    for name, a, b in zip(("out", "gx", "gy"), ours, theirs):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)


def test_grads_reference_fuzz_matches_jax_kernel(rng):
    for trial in range(5):
        B = int(rng.integers(1, 3))
        H = int(rng.choice([8, 16, 24]))
        W = int(rng.choice([128, 256]))
        img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
        grid = rng.uniform(-2.0, 2.0, (B, H, W, 2)).astype(np.float32)
        ours, theirs = _plain_vs_kernel(img, grid)
        for name, a, b in zip(("out", "gx", "gy"), ours, theirs):
            np.testing.assert_allclose(a, b, atol=1e-6,
                                       err_msg=f"trial {trial} {name}")


def test_grads_reference_any_shape_matches_jnp_formulas(rng):
    """6x10, a shape the TPU kernel never took: out against the JAX
    `grid_sample`, gx and gy against the tap differences written in jnp
    from the JAX kernel's own coordinates (`_coords`)."""
    B, H, W, C = 2, 6, 10, 3
    img = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    grid = _warp_grid_np(rng, B, H, W)
    out, gx, gy = (t.numpy() for t in warp_sample_grads_reference(
        torch.from_numpy(img), torch.from_numpy(grid)))
    wx, wy, x0, y0 = (np.asarray(a) for a in jax_coords(jnp.asarray(grid), H, W))
    b = np.arange(B)[:, None, None]
    v00, v01 = img[b, y0, x0], img[b, y0, x0 + 1]
    v10, v11 = img[b, y0 + 1, x0], img[b, y0 + 1, x0 + 1]
    wx, wy = wx[..., None], wy[..., None]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    np.testing.assert_allclose(
        out, np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid))),
        atol=1e-6)
    np.testing.assert_allclose(gx, (1 - wy) * (v01 - v00) + wy * (v11 - v10),
                               atol=1e-6)
    np.testing.assert_allclose(gy, bot - top, atol=1e-6)


def _port_dgrid(sampler, img, grid):
    g = torch.from_numpy(grid).requires_grad_(True)
    (sampler(torch.from_numpy(img), g) ** 2).sum().backward()
    return g.grad.numpy()


def _jax_dgrid(sampler, img, grid):
    return np.asarray(jax.grad(
        lambda g: (sampler(jnp.asarray(img), g) ** 2).sum())(jnp.asarray(grid)))


@pytest.mark.parametrize("field", ["smooth+wild", "uniform"])
def test_warp_dgrid_matches_jax(rng, field):
    """dgrid of `WarpSample` (plain forward on the CPU) against jax.grad
    through the Pallas `warp_sample` (interpret mode) and through the jnp
    `grid_sample`, at the tolerance of tests/test_pallas.py."""
    B, H, W = 2, 16, 128
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    grid = _warp_grid_np(rng, B, H, W) if field == "smooth+wild" \
        else rng.uniform(-2.0, 2.0, (B, H, W, 2)).astype(np.float32)
    ours = _port_dgrid(WarpSample.apply, img, grid)
    for theirs in (_jax_dgrid(lambda i, g: jax_warp_sample(i, g, True), img, grid),
                   _jax_dgrid(jax_grid_sample, img, grid)):
        scale = max(float(np.abs(theirs).max()), 1.0)
        np.testing.assert_allclose(ours, theirs, atol=2e-6 * scale)


def _identity_grid(B, H, W):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    grid = np.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1], -1)
    return grid[None].repeat(B, 0)


@pytest.mark.parametrize("sampler", ["WarpSample", "grid_sample"])
def test_identity_grid_dgrid_matches_jax_f64(rng, sampler):
    """The identity grid puts every border row and column exactly on a
    clip bound, where `jnp.clip` passes half the gradient (`torch.clamp`
    passed all of it: dgrid was off by up to 5.96 there). f64, both the
    kernel path's backward and autograd through the plain `grid_sample`."""
    B, H, W = 2, 8, 12
    img = rng.uniform(size=(B, H, W, 3))
    grid = _identity_grid(B, H, W)
    fn = WarpSample.apply if sampler == "WarpSample" else grid_sample
    ours = _port_dgrid(fn, img, grid)
    with jax.enable_x64(True):
        theirs = _jax_dgrid(jax_grid_sample, img, grid)
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


def test_warp_image_gets_no_gradient(rng):
    """JAX's zero image cotangent, as None: the sources are data."""
    img = torch.from_numpy(rng.uniform(size=(1, 8, 16, 3)).astype(np.float32))
    img.requires_grad_(True)
    grid = torch.from_numpy(_warp_grid_np(rng, 1, 8, 16)).requires_grad_(True)
    WarpSample.apply(img, grid).sum().backward()
    assert img.grad is None
    assert grid.grad is not None and bool(grid.grad.abs().sum() > 0)


def test_grads_cpu_tensor_takes_plain_version_without_counting(rng):
    img = torch.from_numpy(rng.uniform(size=(1, 8, 16, 3)).astype(np.float32))
    grid = torch.from_numpy(_warp_grid_np(rng, 1, 8, 16))
    before = warp_sample_grads.launches
    ours = warp_sample_grads(img, grid)
    assert warp_sample_grads.launches == before
    for a, b in zip(ours, warp_sample_grads_reference(img, grid)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("x", [-1.0, 0.0, 0.5, 1.0, 2.0])
def test_clip_gradient_is_jax_s(x):
    """1 inside, 0.5 on either bound, 0 outside; values as torch.clamp."""
    t = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    out = clip(t, 0.0, 1.0)
    out.backward()
    assert float(out.detach()) == float(torch.clamp(t.detach(), 0.0, 1.0))
    with jax.enable_x64(True):
        theirs = float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(x))
    assert float(t.grad) == theirs


def test_ssim_at_exact_ties_matches_jax_f64(rng):
    """Where two 3x3 patches (nearly) match, the SSIM distance rounds to
    exactly 0, a tie of its clip. f64: values and the gradient match JAX.
    The patches differ by ~1e-9, so the distance's own gradient there is
    ~1e-8 rather than 0 (an exact match is its minimum) and the half the
    tie passes shows: `torch.clamp` was ~2e-9 off."""
    B, H, W, C = 2, 8, 12, 3
    target = rng.uniform(size=(B, H, W, C))
    pred = target + 1e-9 * rng.standard_normal(target.shape)
    pred[:, :, W // 2:] = rng.uniform(size=(B, H, W - W // 2, C))
    weight = rng.uniform(size=(B, H, W, C))
    p = torch.from_numpy(pred).requires_grad_(True)
    dist = ssim(p, torch.from_numpy(target))
    (dist * torch.from_numpy(weight)).sum().backward()
    with jax.enable_x64(True):
        jd = np.asarray(jax_ssim(jnp.asarray(pred), jnp.asarray(target)))
        jg = np.asarray(jax.grad(lambda a: (jax_ssim(a, jnp.asarray(target))
                                            * weight).sum())(jnp.asarray(pred)))
    assert int((jd == 0).sum()) > 100  # the ties are there
    np.testing.assert_array_equal(dist.detach().numpy() == 0, jd == 0)
    np.testing.assert_allclose(dist.detach().numpy(), jd, rtol=0, atol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), jg, rtol=0, atol=1e-12)
