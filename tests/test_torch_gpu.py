"""The port on the card: each CUDA kernel (the warp sampler's, its
backward K1-bwd, its shifted slab form K3, the photometric term's forward
and backward, and the warp-gather probes')
against its plain PyTorch version, the launches of the eval and train
steps (with --remat too), `prefetch_to_device`'s batches on the card,
synced batch norm's own backward against autograd's, the phase marks in
a captured replay's trace, and the steps
captured as CUDA graphs against the eager steps, on one card, on a
2-rank `{data: 2}` and a `{spatial: 2}` mesh over NCCL (which need 2
cards), and the captured steps' spatial warp (the gathered rows, K3) in a
one-rank NCCL world. Marked `gpu`; each test skips without a CUDA device
(the mesh tests without 2). This file imports neither jax nor the JAX package and uses no
conftest fixture, so the host with the card runs it on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.dataset import KittiDataset
from monodepth_tpu_torch.data.pipeline import Loader, prefetch_to_device
from monodepth_tpu_torch.data.synthetic import DRIVE, make_kitti_tree, make_planar_scenes
from monodepth_tpu_torch.ops.cuda import photometric as ph
from monodepth_tpu_torch.ops.cuda import probes
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    WarpSample,
    WarpSampleShifted,
    grid_vjp,
    grid_vjp_reference,
    warp_sample,
    warp_sample_grads,
    warp_sample_grads_reference,
    warp_sample_grads_shifted,
    warp_sample_grads_shifted_reference,
    warp_sample_reference,
    warp_sample_shifted,
    warp_sample_shifted_reference,
)
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import make_eval_step, make_train_step

CASES = [("smooth", (12, 192, 640, 3)), ("wild", (12, 192, 640, 3)),
         ("nan", (12, 192, 640, 3)), ("wild", (3, 7, 33, 4)),
         ("smooth", (1, 2, 2, 1))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(rng, B, H, W, kind):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = (xs + 6.0 * np.sin(xs / 17.0 + ys / 23.0)) / (W - 1) * 2 - 1
    gy = (ys + 1.5 * np.cos(ys / 7.0 + xs / 31.0)) / (H - 1) * 2 - 1
    grid = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    if kind == "wild":
        grid = rng.uniform(-2.5, 2.5, grid.shape).astype(np.float32)
    elif kind == "nan":
        grid[0, 1, 2] = np.nan
        grid[0, 4, 5, 1] = np.inf
        grid[-1, -1, -1, 0] = -np.inf
    return grid


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", CASES)
def test_warp_kernel_matches_plain(cuda, kind, shape):
    rng = np.random.default_rng(0)
    B, H, W, C = shape
    img = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(cuda)
    grid = torch.from_numpy(_field(rng, B, H, W, kind)).to(cuda)
    before = warp_sample.launches
    out = warp_sample(img, grid)
    torch.cuda.synchronize()
    assert warp_sample.launches == before + 1
    plain = warp_sample_reference(img, grid)
    assert torch.equal(out.isnan(), plain.isnan())
    assert float((out - plain).nan_to_num().abs().max()) <= 1e-6
    if kind == "nan":
        assert int(out.isnan().any(-1).sum()) == 1  # the NaN pixel only


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape", CASES)
def test_warp_grads_kernel_matches_plain(cuda, kind, shape):
    """K1: out, gx and gy against the plain version, NaN where it has NaN."""
    rng = np.random.default_rng(0)
    B, H, W, C = shape
    img = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(cuda)
    grid = torch.from_numpy(_field(rng, B, H, W, kind)).to(cuda)
    before = warp_sample_grads.launches
    ours = warp_sample_grads(img, grid)
    torch.cuda.synchronize()
    assert warp_sample_grads.launches == before + 1
    for name, a, b in zip(("out", "gx", "gy"), ours,
                          warp_sample_grads_reference(img, grid)):
        assert torch.equal(a.isnan(), b.isnan()), name
        assert float((a - b).nan_to_num().abs().max()) <= 1e-6, name
    # the eval form's values, NaN where they are NaN
    assert torch.allclose(ours[0], warp_sample(img, grid), rtol=0, atol=0,
                          equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["smooth", "wild"])
def test_warp_dgrid_kernel_matches_plain_forward(cuda, kind):
    """`WarpSample` through K1 and K1-bwd against the plain forward and
    backward: max |diff| <= 1e-6 · max(scale, 1)."""
    rng = np.random.default_rng(1)
    B, H, W, C = 12, 192, 640, 3
    img = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(cuda)
    field = torch.from_numpy(_field(rng, B, H, W, kind)).to(cuda)
    dout = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(cuda)
    dgrids = []
    for plain in (False, True):
        grid = field.clone().requires_grad_(True)
        WarpSample.apply(img, grid, plain).backward(dout)
        dgrids.append(grid.grad)
    scale = max(float(dgrids[1].abs().max()), 1.0)
    assert float((dgrids[0] - dgrids[1]).abs().max()) <= 1e-6 * scale


def _offset(t):
    """A contiguous copy of `t` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(12, 192, 33, 3), (12, 192, 130, 3), (3, 17, 33, 3),
                                   (1, 5, 33, 3), (3, 7, 33, 4)])
def test_warp_grads_kernel_ragged_groups_and_offsets(cuda, shape):
    """K1's pixel groups across rows, a ragged last group and pointers off 16
    bytes: equal to the plain version."""
    rng = np.random.default_rng(4)
    B, H, W, C = shape
    img = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(cuda)
    for kind in ("smooth", "wild", "nan"):
        grid = torch.from_numpy(_field(rng, B, H, W, kind)).to(cuda)
        plain = warp_sample_grads_reference(img, grid)
        runs = [warp_sample_grads(img, grid),
                warp_sample_grads(_offset(img), _offset(grid))]
        torch.cuda.synchronize()
        for ours in runs:
            for a, b in zip(ours, plain):
                assert torch.equal(a.isnan(), b.isnan())
                assert torch.equal(a.nan_to_num(), b.nan_to_num()), (kind, shape)


def _vjp_inputs(rng, cuda, B, H, W, C, kind, full=None):
    """(grid, dout, gx, gy, full height) with gx, gy from K1 (K3 for a
    slab's grid: rows 96-191 of a 192-row image)."""
    img = torch.from_numpy(rng.uniform(size=(B, full or H, W, C)).astype(np.float32)).to(cuda)
    grid = torch.from_numpy(_field(rng, B, full or H, W, kind)).to(cuda)
    if full is None:
        _, gx, gy = warp_sample_grads(img, grid)
        full = H
    else:
        grid = grid[:, full - H:].contiguous()
        _, gx, gy = warp_sample_grads_shifted(img, grid, 0, full)
    dout = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(cuda)
    return grid, dout, gx, gy, full


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape,full", [(k, s, None) for k, s in CASES]
                         + [("smooth", (12, 96, 640, 3), 192), ("wild", (12, 96, 640, 3), 192),
                            ("wild", (3, 7, 33, 4), None), ("smooth", (1, 5, 33, 3), None)])
def test_grid_vjp_kernel_matches_plain(cuda, kind, shape, full):
    """K1-bwd against `grid_vjp_reference`: equal, NaN where it has NaN,
    also off 16 bytes and on an expanded cotangent."""
    rng = np.random.default_rng(5)
    grid, dout, gx, gy, full = _vjp_inputs(rng, cuda, *shape, kind, full)
    before = grid_vjp.launches
    ours = grid_vjp(grid, dout, gx, gy, full)
    unaligned = grid_vjp(*map(_offset, (grid, dout, gx, gy)), full)
    wide = dout[:, :1, :1].expand_as(dout)
    expanded = grid_vjp(grid, wide, gx, gy, full)
    torch.cuda.synchronize()
    assert grid_vjp.launches == before + 3
    plain = grid_vjp_reference(grid, dout, gx, gy, full)
    for out, want in ((ours, plain), (unaligned, plain),
                      (expanded, grid_vjp_reference(grid, wide.contiguous(), gx, gy, full))):
        assert torch.equal(out.isnan(), want.isnan())
        assert torch.equal(out.nan_to_num(), want.nan_to_num())
    if kind == "nan":
        assert bool(ours.isnan().any())


@pytest.mark.gpu
def test_grid_vjp_kernel_rejects_what_it_cannot_take(cuda):
    grid, t = torch.zeros((1, 8, 16, 2), device=cuda), torch.zeros((1, 8, 16, 3), device=cuda)
    with pytest.raises(TypeError):
        grid_vjp(grid.double(), t.double(), t.double(), t.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        grid_vjp(grid, t, t.transpose(1, 2).contiguous().transpose(1, 2), t, 8)
    with pytest.raises(ValueError, match="alike"):
        grid_vjp(grid, t[..., :2], t, t, 8)


@pytest.mark.gpu
def test_stride0_cotangent_on_card(cuda):
    """`out.sum().backward()`'s expanded cotangent through K1-bwd gives
    the dgrid of an explicit `torch.ones`."""
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.uniform(size=(2, 16, 40, 3)).astype(np.float32)).to(cuda)
    field = torch.from_numpy(_field(rng, 2, 16, 40, "smooth")).to(cuda)
    dgrids = []
    for explicit in (False, True):
        g = field.clone().requires_grad_(True)
        out = WarpSample.apply(img, g)
        out.backward(torch.ones_like(out)) if explicit else out.sum().backward()
        dgrids.append(g.grad)
    assert torch.equal(dgrids[0], dgrids[1])


@pytest.mark.gpu
def test_warp_kernel_rejects_what_it_cannot_take(cuda):
    img = torch.zeros((1, 8, 16, 3), device=cuda)
    grid = torch.zeros((1, 8, 16, 2), device=cuda)
    for fn in (warp_sample, warp_sample_grads):
        with pytest.raises(TypeError):
            fn(img.double(), grid.double())
        with pytest.raises(ValueError, match="contiguous"):
            fn(img.transpose(1, 2).contiguous().transpose(1, 2), grid)


# --- the photometric term: forward and backward kernels against plain --

PHOTOMETRIC_SHAPES = [(2, 7, 9), (2, 64, 96), (2, 192, 640)]
# the forward rounds as the plain ops do (csrc/photometric.cu) but for the
# channel means' order of summation: a few ulps of errors under 1
PHOTOMETRIC_VALUE_ATOL = 1e-6
# the backward sums each pixel's 5x5 footprint of windows in another order
# than autograd's chain of pooled-tensor backwards, and mean(x^2) - mu^2
# cancels: relative to the gradient's largest entry
PHOTOMETRIC_GRAD_RTOL = 1e-5


def _photometric_images(shape, F, seed, dev, kind="plain"):
    """warps, sources, target [B, H, W, 3] and noise [B, H, W, F] on the
    card: warps near the target (errors of the identity's size), an exact
    tie of two warps, the first warp equal to the target over a patch (SSIM
    distance exactly 0, where the clip passes half the gradient), or a NaN
    in the first warp."""
    B, H, W = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    target = torch.rand(B, H, W, 3, generator=g, device=dev)
    warps = [0.6 * torch.rand(B, H, W, 3, generator=g, device=dev) + 0.3 * target
             for _ in range(F)]
    sources = [torch.rand(B, H, W, 3, generator=g, device=dev) for _ in range(F)]
    noise = 1e-5 * torch.randn(B, H, W, F, generator=g, device=dev)
    if kind == "tie":
        warps[1] = warps[0].clone()
    elif kind == "ssim_tie":
        warps[0][:, 4:12, 6:20] = target[:, 4:12, 6:20]
    elif kind == "nan":
        warps[0][0, H // 2, W // 2, 1] = float("nan")
    return warps, sources, target, noise


def _check_photometric(warps, sources, target, noise, automask):
    """The kernel pair against the plain versions: the identity and the
    minimum within PHOTOMETRIC_VALUE_ATOL, NaN where plain has NaN, the
    mask equal wherever no channel lies within 2e-6 of the minimum without
    equalling it, and each warp's gradient against the plain backward from
    the kernel's mask within PHOTOMETRIC_GRAD_RTOL, NaN where it has NaN."""
    before = _photometric_counts()
    identity = ph.identity_errors(sources, target) if automask else None
    leaves = [w.clone().requires_grad_(True) for w in warps]
    minimum, mask = ph.photometric_min(leaves, target, identity, noise if automask else None)
    dmin = torch.randn(minimum.shape, device=target.device,
                       generator=torch.Generator(device=target.device).manual_seed(7))
    minimum.backward(dmin)
    torch.cuda.synchronize()
    assert _photometric_counts() == (before[0] + int(automask), before[1] + 1, before[2] + 1)
    assert minimum.dtype == torch.float32 and mask.dtype == torch.uint8

    if automask:
        plain_identity = torch.cat([ph.reprojection_error(s, target) for s in sources], -1)
        assert float((identity - plain_identity).abs().max()) <= PHOTOMETRIC_VALUE_ATOL
    plain_min, plain_mask = ph.photometric_min_reference(
        warps, target, identity, noise if automask else None)
    assert torch.equal(minimum.isnan(), plain_min.isnan())
    assert float((minimum.detach() - plain_min).nan_to_num().abs().max()) \
        <= PHOTOMETRIC_VALUE_ATOL
    reproj = torch.cat([ph.reprojection_error(w, target) for w in warps], -1)
    combined = reproj if not automask else torch.cat([identity + noise, reproj], -1)
    gap = (combined - plain_min[..., None]).abs()
    near = ((gap <= 2e-6) & (gap > 0)).any(-1)
    assert bool(((mask == plain_mask) | near).all())
    assert float(near.float().mean()) < 1e-3

    for got, want in zip(leaves, ph.photometric_min_grads_reference(
            warps, target, mask, dmin, automask)):
        assert torch.equal(got.grad.isnan(), want.isnan())
        scale = float(want.nan_to_num().abs().max())
        err = float((got.grad - want).nan_to_num().abs().max()) / max(scale, 1e-30)
        assert err <= PHOTOMETRIC_GRAD_RTOL, err


@pytest.mark.gpu
@pytest.mark.parametrize("automask", [True, False])
@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("shape", PHOTOMETRIC_SHAPES)
def test_photometric_kernels_match_plain(cuda, shape, F, automask):
    """identity_errors, photometric_min and its backward, one launch each,
    against the plain versions at an odd shape, the eval shape and the
    headline width, for mono, stereo and mono+stereo sources."""
    _check_photometric(*_photometric_images(shape, F, sum(shape) + F, cuda), automask)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tie", "ssim_tie", "nan"])
def test_photometric_kernels_keep_ties_and_nan(cuda, kind):
    """Two equal warps tie exactly in the kernel too (both bits set, the
    cotangent split in two); a warp equal to the target over a patch gives
    errors exactly 0 inside it, as plain; a NaN pixel gives a NaN minimum
    over its windows and NaN gradients over their footprint, where plain
    has them."""
    warps, sources, target, noise = _photometric_images((2, 24, 40), 2, 5, cuda, kind)
    _check_photometric(warps, sources, target, noise, kind != "ssim_tie")
    if kind == "ssim_tie":  # automasking off: the minimum is the errors' alone
        minimum, _ = ph.photometric_min(warps, target, None, None)
        plain, _ = ph.photometric_min_reference(warps, target, None, None)
        assert torch.equal(minimum == 0, plain == 0) and int((minimum == 0).sum()) >= 2 * 6 * 12
        return
    identity = ph.identity_errors(sources, target)
    minimum, mask = ph.photometric_min(warps, target, identity, noise)
    if kind == "tie":
        assert bool(((mask >> 2) & 3 == 3).any())
    else:
        assert int(minimum.isnan().sum()) == 9
        assert bool((mask[minimum.isnan()] & ph.NAN_MIN).all())
        assert torch.equal(ph.first_choice(mask)[minimum.isnan()],
                           torch.full((9,), 2, device=cuda))


@pytest.mark.gpu
def test_photometric_backward_is_deterministic(cuda):
    """Two backward launches on the same inputs give the same bits (a
    gather, no atomics)."""
    warps, sources, target, noise = _photometric_images((12, 192, 640), 2, 1, cuda)
    identity = ph.identity_errors(sources, target)
    _, mask = ph.photometric_min(warps, target, identity, noise)
    dmin = torch.rand(mask.shape, device=cuda)
    first = ph.photometric_min_grads(warps, target, mask, dmin, True)
    second = ph.photometric_min_grads(warps, target, mask, dmin, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_photometric_stride0_cotangent_on_card(cuda):
    """`minimum.sum().backward()`'s expanded cotangent, read as one float,
    gives the gradients of an explicit `torch.ones`; a strided cotangent is
    made contiguous."""
    warps, sources, target, noise = _photometric_images((2, 16, 40), 2, 2, cuda)
    identity = ph.identity_errors(sources, target)
    grads = []
    for how in ("sum", "ones", "strided"):
        leaves = [w.clone().requires_grad_(True) for w in warps]
        minimum, _ = ph.photometric_min(leaves, target, identity, noise)
        if how == "sum":
            minimum.sum().backward()
        elif how == "ones":
            minimum.backward(torch.ones_like(minimum))
        else:
            minimum.backward(torch.ones(2, 40, 16, device=cuda).transpose(1, 2))
        grads.append([w.grad for w in leaves])
    for g in grads[1:]:
        for a, b in zip(grads[0], g):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_photometric_kernels_reject_what_they_cannot_take(cuda):
    """Wrong dtype, device, shape or layout raise before any launch."""
    t = torch.rand(1, 8, 16, 3, device=cuda)
    ident = torch.rand(1, 8, 16, 1, device=cuda)
    before = _photometric_counts()
    with pytest.raises(TypeError):
        ph.identity_errors([t.double()], t.double())
    with pytest.raises(TypeError):
        ph.photometric_min([t], t, ident, ident.double())
    with pytest.raises(ValueError, match="an image on"):
        ph.photometric_min([t.cpu()], t, None, None)
    with pytest.raises(ValueError, match="tensors on"):
        ph.photometric_min([t], t, ident.cpu(), ident.cpu())
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        ph.photometric_min([torch.rand(1, 8, 16, 4, device=cuda)],
                           torch.rand(1, 8, 16, 4, device=cuda), None, None)
    with pytest.raises(ValueError, match="identity and noise"):
        ph.photometric_min([t], t, torch.rand(1, 8, 16, 2, device=cuda),
                           torch.rand(1, 8, 16, 2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ph.photometric_min([t.transpose(1, 2).contiguous().transpose(1, 2)], t, None, None)
    with pytest.raises(ValueError, match="no gradient"):
        ph.photometric_min([t], t.clone().requires_grad_(True), None, None)
    mask = torch.zeros(1, 8, 16, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8 mask"):
        ph.photometric_min_grads([t], t, mask.float(), torch.ones(1, 8, 16, device=cuda), False)
    with pytest.raises(ValueError, match="cotangent"):
        ph.photometric_min_grads([t], t, mask, torch.ones(1, 8, 16, device=cuda).double(),
                                 False)
    assert _photometric_counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_synced_norm_is_autograd_bit_for_bit_on_card(cuda, dtype):
    """Synced batch norm's own backward gives the bits of plain autograd
    through the same ops on the card too, at a layer1 shape of the
    640x192 b12 step (a one-rank gloo group; tests/test_torch_rows.py
    checks three CPU ranks)."""
    import torch.distributed as dist
    from torch_rows_worker import synced_norm_by_autograd

    from monodepth_tpu_torch.models.resnet import BatchNorm2d

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        gen = torch.Generator(device=cuda).manual_seed(0)
        x = (torch.randn(12, 64, 48, 160, device=cuda, generator=gen) * 0.7 + 3.0).to(dtype)
        cot = torch.randn(x.shape, device=cuda, generator=gen).to(dtype)
        bn = BatchNorm2d(64).to(cuda).train()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(64, device=cuda, generator=gen) + 0.5)
            bn.bias.copy_(torch.rand(64, device=cuda, generator=gen) - 0.5)
        bn.process_group = dist.group.WORLD
        got = {}
        for how, fn in (("module", bn), ("autograd", lambda t: synced_norm_by_autograd(bn, t))):
            t = x.clone().requires_grad_(True)
            bn.zero_grad(set_to_none=True)
            y = fn(t)
            (y.float() * cot.float()).sum().backward()
            got[how] = [y, t.grad, bn.weight.grad, bn.bias.grad]
        for mine, plain in zip(got["module"], got["autograd"]):
            assert torch.equal(mine, plain)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_eval_step_on_card_matches_cpu(cuda):
    """f32, small: the card's eval step (8 warp kernel launches; the
    photometric term's identity once and forward once a scale) against the
    CPU step (plain warp and loss) on the same weights, batch and noise.
    TF32 is off under f32, so only summation order separates the two."""
    cfg = Config(height=64, width=128, batch=2, precision="f32")
    scenes = make_planar_scenes(2, 64, 128, seed=0)
    batch = {k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")}
    noise = {s: 1e-5 * torch.randn(2, 64, 128, 2,
                                   generator=torch.Generator().manual_seed(s))
             for s in cfg.scales}
    model = build_model(cfg, device="cpu")
    cpu = make_eval_step(model, cfg, device="cpu")(
        create_state(cfg, model), batch, noise=noise)
    model = model.to(cuda)
    before = warp_sample.launches, _photometric_counts()
    card = make_eval_step(model, cfg)(create_state(cfg, model), batch,
                                      noise=noise)
    assert warp_sample.launches == before[0] + 8
    assert _photometric_counts() == tuple(a + b for a, b in zip(before[1], (1, 4, 0)))
    np.testing.assert_allclose(float(card["loss"]), float(cpu["loss"]), rtol=1e-4)
    assert float(card["warp_span"]) == pytest.approx(float(cpu["warp_span"]),
                                                     abs=0.125)


@pytest.mark.gpu
def test_train_step_launches_k1_eight_times(cuda):
    """f32, small: one train step on the card launches K1 and K1-bwd once
    per warp (2 sources x 4 scales) and K2 never, the photometric term's
    identity once and its forward and backward once a scale, and its loss
    agrees with the CPU step's (plain warp and loss) from the same weights,
    batch and noise."""
    cfg = Config(height=64, width=128, batch=2, precision="f32")
    scenes = make_planar_scenes(2, 64, 128, seed=0)
    batch = {k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")}
    noise = {s: 1e-5 * torch.randn(2, 64, 128, 2,
                                   generator=torch.Generator().manual_seed(s))
             for s in cfg.scales}
    model = build_model(cfg, device="cpu")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    cpu = make_train_step(model, cfg, device="cpu")(
        create_state(cfg, model, steps_per_epoch=10), batch, noise=noise)
    model = build_model(cfg)
    model.load_state_dict(sd)
    before = (warp_sample.launches, warp_sample_grads.launches, grid_vjp.launches)
    photometric_before = _photometric_counts()
    card = make_train_step(model, cfg)(create_state(cfg, model, steps_per_epoch=10),
                                       batch, noise=noise)
    torch.cuda.synchronize()
    assert (warp_sample.launches, warp_sample_grads.launches, grid_vjp.launches) == \
        (before[0], before[1] + 8, before[2] + 8)
    assert _photometric_counts() == tuple(a + b for a, b in zip(photometric_before, (1, 4, 4)))
    np.testing.assert_allclose(float(card["loss"]), float(cpu["loss"]), rtol=1e-4)


@pytest.mark.gpu
def test_train_step_is_deterministic(cuda):
    """bf16 at the headline width, small batch: two train steps from one
    state, the kernel warp (K1, K1-bwd) in one and the plain warp (forward
    and backward) in the other, give the same loss and bit-identical
    gradients."""
    import copy

    cfg = Config(height=192, width=640, batch=2)
    scenes = make_planar_scenes(2, 192, 640, seed=0)
    batch = {k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")}
    state = create_state(cfg, build_model(cfg), steps_per_epoch=10)
    twin = copy.deepcopy(state)
    a = make_train_step(state.model, cfg)(state, batch)
    b = make_train_step(twin.model, cfg, sampler=lambda im, gr: WarpSample.apply(
        im, gr, True))(twin, batch)
    assert float(a["loss"]) == float(b["loss"])
    for (name, p), q in zip(state.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p.grad, q.grad), name


def _probe_inputs(rng, shape, lo, hi):
    return (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)),
            torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (3, 200)])
def test_take_along_axis_kernel_matches_plain(cuda, shape):
    """P-A: wrap in [-L, 0), NaN beyond, exactly as the plain version."""
    L = shape[1]
    tab, idx = (t.to(cuda) for t in _probe_inputs(np.random.default_rng(0), shape,
                                                   -2 * L, 2 * L))
    before = probes.take_along_axis.launches
    out = probes.take_along_axis(tab, idx)
    torch.cuda.synchronize()
    assert probes.take_along_axis.launches == before + 1
    plain = probes.take_along_axis_reference(tab, idx)
    nan = plain.isnan()
    assert torch.equal(out.isnan(), nan) and bool(nan.any())
    assert torch.equal(torch.where(nan, 0.0, out), torch.where(nan, 0.0, plain))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (8, 640), (5, 384)])
def test_row_gather_kernel_matches_plain(cuda, shape):
    W = shape[1]
    row, idx = (t.to(cuda) for t in _probe_inputs(np.random.default_rng(1), shape,
                                                   -W // 2, W + W // 2))
    before = probes.row_gather.launches
    out = probes.row_gather(row, idx)
    torch.cuda.synchronize()
    assert probes.row_gather.launches == before + 1
    assert torch.equal(out, probes.row_gather_reference(row, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lim", [((192, 640), (50, 61)), ((64, 256), (0, 64)),
                                       ((64, 256), (7, 7)), ((64, 256), (9, 3)),
                                       ((97, 640), (0, 97)), ((16, 128), (-5, 40))])
def test_row_sum_kernel_matches_plain(cuda, shape, lim):
    """P-C, the bounds on the device; the last case is clamped to [0, H]."""
    src = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, shape)
                           .astype(np.float32)).to(cuda)
    lim = torch.tensor(lim, dtype=torch.int32, device=cuda)
    before = probes.row_sum.launches
    out = probes.row_sum(src, lim)
    torch.cuda.synchronize()
    assert probes.row_sum.launches == before + 1
    assert torch.equal(out, probes.row_sum_reference(src, lim))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_y", [((12, 192, 640), 4), ((2, 16, 256), 1),
                                       ((2, 16, 256), 8), ((1, 8, 128), 8)]
                         + [((12, 192, 640), n) for n in (1, 2, 3, 5, 6, 7, 8)]
                         + [((1, 8, 128), n) for n in (1, 4)]
                         + [((1, 8, probes.slab_max_width(8)), 8),
                            ((2, 16, probes.slab_max_width(4)), 4),
                            ((1, 8, probes.slab_max_width(1)), 1)])
def test_slab_gather_kernel_matches_plain(cuda, shape, n_y):
    """P-D bit for bit, indices 1/8 of W either side of [0, W): every n_y at
    the probe's shape, the smallest slab, and the widest rows that one
    block's shared memory holds (above 48 KB, by request)."""
    W = shape[2]
    src, idx = (t.to(cuda) for t in _probe_inputs(np.random.default_rng(3), shape,
                                                   -W // 8, W + W // 8))
    before = probes.slab_gather.launches
    out = probes.slab_gather(src, idx, n_y)
    torch.cuda.synchronize()
    assert probes.slab_gather.launches == before + 1
    assert _bits_equal(out, probes.slab_gather_reference(src, idx, n_y))


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n_y", [1, 8])
def test_slab_gather_kernel_out_of_range_indices(cuda, n_y):
    """Rows of negative indices, of indices at and past W, and the int32
    extremes add 0 terms; a row of -0.0 sources keeps the plain version's
    +0.0 sums."""
    B, H, W = 2, 16, 256
    rng = np.random.default_rng(5)
    src = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    src[1, 8] = -0.0
    idx = rng.integers(0, W, (B, H, W)).astype(np.int32)
    idx[0, 0] = rng.integers(-W, 0, W)
    idx[0, 1] = rng.integers(W, 2 * W, W)
    idx[0, 2] = W
    idx[0, 3, ::2], idx[0, 3, 1::2] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    idx[1, 9] = -1
    src, idx = torch.from_numpy(src).to(cuda), torch.from_numpy(idx).to(cuda)
    out = probes.slab_gather(src, idx, n_y)
    assert _bits_equal(out, probes.slab_gather_reference(src, idx, n_y))
    assert torch.equal(out.view(torch.int32)[0, :4], torch.zeros_like(idx[0, :4]))


@pytest.mark.gpu
def test_slab_gather_kernel_rejects_rows_beyond_shared_memory(cuda):
    """n_y whole rows must fit one block's shared memory: one lane chunk
    wider raises on the card with the limit, the plain version takes it."""
    for n_y in (8, 4):
        W = probes.slab_max_width(n_y) + probes.LANES
        src, idx = torch.zeros((1, 8, W), device=cuda), torch.zeros(
            (1, 8, W), dtype=torch.int32, device=cuda)
        before = probes.slab_gather.launches
        with pytest.raises(ValueError, match=f"W <= {W - probes.LANES} at n_y = {n_y}"):
            probes.slab_gather(src, idx, n_y)
        assert probes.slab_gather.launches == before
    assert probes.slab_gather_reference(src, idx, 4).shape == (1, 8, W)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["src", "idx"])
def test_slab_gather_kernel_rejects_a_storage_offset(cuda, which):
    """The bulk copy, int4 loads and float4 stores need 16-byte aligned
    pointers: a contiguous view 4 bytes off raises; an aligned copy of it
    gives the plain version's result."""
    src, idx = (t.to(cuda) for t in _probe_inputs(np.random.default_rng(6), (2, 16, 256),
                                                   -32, 288))
    args = {"src": src, "idx": idx}
    args[which] = _offset(args[which])
    with pytest.raises(ValueError, match="16-byte"):
        probes.slab_gather(args["src"], args["idx"], 4)
    args[which] = args[which].clone()
    assert _bits_equal(probes.slab_gather(args["src"], args["idx"], 4),
                       probes.slab_gather_reference(src, idx, 4))


def _slab(img, s, n, halo):
    """Shard s of n's slab of img [B, H, W, C], zeros beyond the image ->
    (slab, row0)."""
    B, H, W, C = img.shape
    Hl = H // n
    lo = s * Hl - halo
    slab = img.new_zeros((B, Hl + 2 * halo, W, C))
    src_lo, src_hi = max(lo, 0), min(lo + Hl + 2 * halo, H)
    slab[:, src_lo - lo:src_hi - lo] = img[:, src_lo:src_hi]
    return slab, lo


SHIFTED_CASES = [("smooth", (12, 192, 640, 3), 2, 64), ("smooth", (12, 192, 640, 3), 4, 48),
                 ("wild", (12, 192, 640, 3), 2, 64), ("nan", (12, 192, 640, 3), 2, 64),
                 ("wild", (3, 14, 33, 4), 2, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape,n,halo", SHIFTED_CASES)
def test_shifted_kernels_match_plain(cuda, kind, shape, n, halo):
    """K3, both forms, every shard: against the plain version (max |diff|
    <= 1e-6, NaN where it has NaN), and the eval form's values equal the
    train form's."""
    rng = np.random.default_rng(0)
    B, H, W, C = shape
    img = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(cuda)
    grid = torch.from_numpy(_field(rng, B, H, W, kind)).to(cuda)
    Hl = H // n
    for s in range(n):
        slab, row0 = _slab(img, s, n, halo)
        rows = grid[:, s * Hl:(s + 1) * Hl].contiguous()
        before = warp_sample_shifted.launches, warp_sample_grads_shifted.launches
        out = warp_sample_shifted(slab, rows, row0, H)
        ours = warp_sample_grads_shifted(slab, rows, row0, H)
        torch.cuda.synchronize()
        assert (warp_sample_shifted.launches, warp_sample_grads_shifted.launches) == \
            (before[0] + 1, before[1] + 1)
        plains = [warp_sample_shifted_reference(slab, rows, row0, H),
                  *warp_sample_grads_shifted_reference(slab, rows, row0, H)]
        for name, a, b in zip(("eval", "out", "gx", "gy"), (out, *ours), plains):
            assert torch.equal(a.isnan(), b.isnan()), (s, name)
            assert float((a - b).nan_to_num().abs().max()) <= 1e-6, (s, name)
        assert torch.allclose(out, ours[0], rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
def test_shifted_kernels_stitch_to_the_whole_warp(cuda):
    """On a smooth field every tap lies in its slab: the shards of K3
    stitch to K1/K2 on the whole image bit for bit, and
    `WarpSampleShifted`'s dgrid to `WarpSample`'s."""
    rng = np.random.default_rng(2)
    B, H, W, C, n, halo = 12, 192, 640, 3, 2, 64
    img = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(cuda)
    grid = torch.from_numpy(_field(rng, B, H, W, "smooth")).to(cuda)
    dout = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(cuda)
    g = grid.clone().requires_grad_(True)
    whole = WarpSample.apply(img, g)
    whole.backward(dout)
    Hl = H // n
    outs, evals, dgrids = [], [], []
    for s in range(n):
        slab, row0 = _slab(img, s, n, halo)
        rows = grid[:, s * Hl:(s + 1) * Hl].contiguous().requires_grad_(True)
        out = WarpSampleShifted.apply(slab, rows, row0, H)
        out.backward(dout[:, s * Hl:(s + 1) * Hl])
        outs.append(out.detach())
        dgrids.append(rows.grad)
        evals.append(warp_sample_shifted(slab, rows.detach(), row0, H))
    assert torch.equal(torch.cat(outs, 1), whole.detach())
    assert torch.equal(torch.cat(evals, 1), warp_sample(img, grid))
    scale = max(float(g.grad.abs().max()), 1.0)
    assert float((torch.cat(dgrids, 1) - g.grad).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_shifted_kernel_rejects_what_it_cannot_take(cuda):
    slab = torch.zeros((1, 12, 16, 3), device=cuda)
    grid = torch.zeros((1, 8, 16, 2), device=cuda)
    for fn in (warp_sample_shifted, warp_sample_grads_shifted):
        with pytest.raises(TypeError):
            fn(slab.double(), grid.double(), -2, 16)
        with pytest.raises(ValueError, match="contiguous"):
            fn(slab.transpose(1, 2).contiguous().transpose(1, 2), grid, -2, 16)


def _kitti_loader(tmp_path, batch: int = 4):
    root = make_kitti_tree(str(tmp_path / "kitti"), num_frames=8, image_hw=(96, 320))
    lines = [f"{DRIVE} {i} {side}" for i in range(1, 7) for side in "lr"]
    dataset = KittiDataset(root, lines, is_training=True, frame_ids=(0, -1, 1),
                           height=64, width=128)
    return Loader(dataset, batch, shuffle=True, num_workers=2, seed=1,
                  process_index=0, process_count=1)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [1, 2])
def test_prefetch_to_card_equals_the_host_batches(cuda, tmp_path, size):
    """Every batch `prefetch_to_device` stages on the card (pinned copies
    on a side stream) equals the host batch, in order, and a kernel on the
    consumer's stream reads it right after it is yielded."""
    loader = _kitti_loader(tmp_path)
    try:
        host = list(loader.epoch(0))
        card = []
        for batch in prefetch_to_device(loader.epoch(0), size=size):
            assert all(t.device.type == "cuda" for t in batch.values())
            card.append({k: (v.clone(), float(v.double().sum())) for k, v in batch.items()})
    finally:
        loader.close()
    assert len(card) == len(host) == 3
    for got, want in zip(card, host):
        assert got.keys() == want.keys()
        for key, (tensor, total) in got.items():
            assert torch.equal(tensor.cpu(), torch.from_numpy(want[key])), key
            assert total == float(want[key].astype(np.float64).sum()), key


@pytest.mark.gpu
def test_remat_train_step_launches_k1_twice_a_warp(cuda, tmp_path):
    """f32, small, a `Loader` batch: with --remat one train step launches K1
    16 times (each warp recomputed in the backward) and K1-bwd 8, and
    equals the step without remat."""
    import copy
    import dataclasses

    cfg = Config(height=64, width=128, batch=4, precision="f32")
    loader = _kitti_loader(tmp_path)
    try:
        batch = next(iter(loader.epoch(0)))
    finally:
        loader.close()
    state = create_state(cfg, build_model(cfg), steps_per_epoch=10)
    twin = copy.deepcopy(state)
    for enc in (twin.model.encoder, twin.model.pose_encoder):
        enc.remat = True
    remat_cfg = dataclasses.replace(cfg, remat=True)
    counts = []
    losses = []
    for c, s in ((cfg, state), (remat_cfg, twin)):
        before = (warp_sample_grads.launches, grid_vjp.launches)
        losses.append(float(make_train_step(s.model, c)(s, batch)["loss"]))
        torch.cuda.synchronize()
        counts.append((warp_sample_grads.launches - before[0], grid_vjp.launches - before[1]))
    assert counts == [(8, 8), (16, 8)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for (name, a), b in zip(state.model.named_buffers(), twin.model.buffers()):
        assert torch.equal(a, b), name


def _gloo_card_rank(out_dir) -> None:
    """One of 2 gloo ranks sharing the card (`run_steps.spawn` target):
    the halo exchange of a {spatial: 2} mesh, an all-gather and the stop
    flag's max, on CUDA tensors; writes out_dir/rank<r>.pt."""
    import os

    import torch.distributed as dist

    from monodepth_tpu_torch.parallel.mesh import (
        agree_max,
        all_gather_cat,
        exchange_halo,
        init_distributed,
        make_mesh,
    )

    init_distributed("cuda", timeout_s=60, backend="gloo")
    mesh = make_mesh(1, 2, "cuda")
    rows = torch.arange(2 * 6 * 4, dtype=torch.float32, device=mesh.device) \
        .reshape(2, 6, 4) + 100 * mesh.rank
    prev, nxt = exchange_halo(rows, 2, mesh)
    gathered = all_gather_cat(rows, mesh.spatial_group, 1)
    flag = agree_max(mesh, float(mesh.rank == 1))
    torch.save({"device": str(mesh.device), "backend": dist.get_backend(),
                "prev": prev.cpu(), "next": nxt.cpu(), "gathered": gathered.cpu(),
                "flag": flag}, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.gpu
def test_gloo_ranks_share_one_card(cuda, tmp_path):
    """`init_distributed(backend="gloo")` puts 2 ranks on one card: the
    halo rows (staged through host memory, as gloo sends host tensors
    only), the all-gather and the all-reduced stop flag arrive on the
    card as on the CPU."""
    from monodepth_tpu_torch.parallel.run_steps import spawn

    codes = spawn(_gloo_card_rank, 2, str(tmp_path), deadline_s=240)
    assert codes == [0, 0], codes
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    rows = [torch.arange(48, dtype=torch.float32).reshape(2, 6, 4) + 100 * r
            for r in range(2)]
    for r, got in enumerate(ranks):
        assert got["device"] == f"cuda:{r % torch.cuda.device_count()}"
        assert got["backend"] == "gloo" and got["flag"] == 1.0
        assert torch.equal(got["gathered"], torch.cat(rows, 1))
    assert torch.equal(ranks[0]["next"], rows[1][:, :2])
    assert torch.equal(ranks[1]["prev"], rows[0][:, 4:])
    assert not ranks[0]["prev"].any() and not ranks[1]["next"].any()


@pytest.mark.gpu
def test_nccl_refuses_more_ranks_than_cards(cuda, monkeypatch):
    """NCCL puts one rank on each card: more local ranks than cards raise
    before any process group starts."""
    import torch.distributed as dist

    from monodepth_tpu_torch.parallel.mesh import init_distributed

    n = torch.cuda.device_count() + 1
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="one rank on each card"):
        init_distributed("cuda")
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_export_inference_on_the_card(cuda):
    """The `torch.export` program of the bf16 infer step, built on the
    card, equals `make_infer_step` at max |diff| <= 1e-3 · max |disp|, for
    two batch sizes (dynamic batch)."""
    from monodepth_tpu_torch.tools.export_inference import build_exported
    from monodepth_tpu_torch.training.step import make_infer_step

    cfg = Config(height=64, width=128, scales=(0, 1), weight_init=False)
    model = build_model(cfg)
    program = build_exported(cfg, model).module()
    infer = make_infer_step(model, cfg)
    for b in (1, 5):
        images = torch.rand(b, 64, 128, 3, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(b))
        with torch.no_grad():
            got = program(images)
        want = infer(images)
        assert got.shape == (b, 64, 128) and got.device.type == "cuda"
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


# --- the steps as CUDA graphs: captured against eager, max |diff| 0 -----

@pytest.fixture
def deterministic(cuda):
    """cuDNN deterministic, as every exact pair on the card: a capture
    keeps the algorithms cuDNN picks, and only deterministic ones pick
    alike in two runs."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = saved


GRAPH_CFG = dict(height=64, width=96, batch=2, weight_init=False)  # bf16


def _graph_batches(n, seed=0):
    cfg = Config(**GRAPH_CFG)
    out = []
    for i in range(n):
        scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=seed + i)
        out.append({k: scenes[k] for k in ("frames", "jitter", "K", "inv_K")})
    return out


def _counts():
    return (warp_sample.launches, warp_sample_grads.launches, grid_vjp.launches)


def _photometric_counts():
    return (ph.identity_errors.launches, ph.photometric_min.launches,
            ph.photometric_min_grads.launches)


def _assert_train_states_equal(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        for key in sa[i]:
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert a.step == b.step


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_captured_train_steps_equal_eager(deterministic, k):
    """3 calls of the captured step (warm-up, capture and replay, replay)
    against the eager step from a deep copy: the state (parameters,
    buffers, Adam) and the metrics equal, 8 K1 and 8 K1-bwd launches a
    step counted on both, and the photometric term's 1 identity, 4 forward
    and 4 backward launches, Adam's device step equal to `state.step`; K=2:
    `make_train_multi_step`, 2 steps a call."""
    import copy

    from monodepth_tpu_torch.training.step import make_train_multi_step

    cfg = Config(**GRAPH_CFG)
    batches = _graph_batches(3 * k)
    state = create_state(cfg, build_model(cfg), steps_per_epoch=4)
    twin = copy.deepcopy(state)
    if k == 1:
        graphed, eager = make_train_step(state.model, cfg), \
            make_train_step(twin.model, cfg, graph=False)
        calls = [b for b in batches]
    else:
        graphed, eager = make_train_multi_step(state.model, cfg), \
            make_train_multi_step(twin.model, cfg, graph=False)
        calls = [batches[i:i + k] for i in range(0, len(batches), k)]
    counts = []
    for fn, s in ((graphed, state), (eager, twin)):
        before = _counts() + _photometric_counts()
        metrics = [fn(s, c) for c in calls]
        torch.cuda.synchronize()
        counts.append(tuple(a - b for a, b in zip(_counts() + _photometric_counts(), before)))
        s.metrics = metrics
    # a call: 8 K1 and 8 K1-bwd; the photometric identity once, its
    # forward and backward once a scale (4), each step of a K-step call
    assert counts == [(0, 24 * k, 24 * k, 3 * k, 12 * k, 12 * k)] * 2
    _assert_train_states_equal(state, twin)
    for a, b in zip(state.metrics, twin.metrics):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    steps = {float(e["step"]) for e in state.optimizer.state.values()}
    assert steps == {float(state.step)} == {3.0 * k}


@pytest.mark.gpu
def test_captured_replay_carries_the_phase_marks(cuda):
    """The captured train step at 640x192 b2, handed batches on the card
    and tie noise drawn ahead: its warm-up and capture are host ranges;
    in a `torch.profiler` trace of two replays each `phase_mark_*` runs
    once a step in the order of `PHASES` (no grad_sync without a mesh),
    the device's work between each step's first and last mark covers its
    busy time within 1% (the rest: the inputs staged and the outputs
    cloned), and each call shows its "train_step/call" and
    "graphed_step/stage" ranges."""
    from torch.profiler import ProfilerActivity, profile

    from monodepth_tpu_torch.training.phases import PHASES
    from monodepth_tpu_torch.training.step import draw_tie_noise

    def union(spans):
        total, reach = 0.0, float("-inf")
        for start, end in sorted(spans):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        return total

    cfg = Config(height=192, width=640, batch=2, weight_init=False)
    batches = []
    for i in range(3):
        scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=i)
        batches.append({k: torch.as_tensor(scenes[k]).cuda()
                        for k in ("frames", "jitter", "K", "inv_K")})
    noises = [draw_tie_noise(cfg, b, 0, i, None, torch.device("cuda"))
              for i, b in enumerate(batches)]
    state = create_state(cfg, build_model(cfg), steps_per_epoch=4)
    step = make_train_step(state.model, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batches[0], noises[0])
        step(state, batches[1], noises[1])
    names = [e.name for e in prof.events()]
    assert names.count("graphed_step/warm_up") == 1 and names.count("graphed_step/capture") == 1

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batches[2], noises[2])
        step(state, batches[0], noises[0])
        torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    host = [e.name for e in prof.events() if e.device_type != cuda_type]
    ranges = set(host)  # a host range also shows on the device timeline
    device = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == cuda_type and e.name not in ranges)
    marks = [d for d in device if d[2].startswith("phase_mark_")]
    ops = [d[:2] for d in device if not d[2].startswith("phase_mark_")]
    assert [m[2] for m in marks] == [f"phase_mark_{p}" for p in PHASES if p != "grad_sync"] * 2
    windows = [(a[1], b[0]) for a, b in zip(marks, marks[1:]) if a[2] != "phase_mark_end"]
    inside = union([(max(s, lo), min(e, hi)) for s, e in ops for lo, hi in windows
                    if s < hi and e > lo])
    assert inside == pytest.approx(union(ops), rel=0.01)
    assert host.count("train_step/call") == 2 and host.count("graphed_step/stage") == 2


@pytest.mark.gpu
def test_captured_eval_and_infer_equal_eager(deterministic):
    """The eval step (3 batches, each its own noise index) and the infer
    step (batch 2 three times, then batch 5: a second capture) captured
    against `graph=False`: max |diff| 0, K2 8 launches an eval call."""
    from monodepth_tpu_torch.training.step import make_infer_step

    cfg = Config(**GRAPH_CFG)
    batches = _graph_batches(3)
    model = build_model(cfg)
    state = create_state(cfg, model)
    results = []
    for graph in (None, False):
        step, infer = make_eval_step(model, cfg, graph=graph), \
            make_infer_step(model, cfg, graph=graph)
        before = _counts()
        metrics = [step(state, b, i) for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_counts(), before)) == (24, 0, 0)
        images = [b["frames"][:, 0].astype(np.float32) / 255.0 for b in batches]
        images.append(np.concatenate(images + images[:1])[:5])
        images.append(images[-1] * 0.5)
        results.append((metrics, [infer(x) for x in images]))
    (m_graph, d_graph), (m_eager, d_eager) = results
    for a, b in zip(m_graph, m_eager):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for a, b in zip(d_graph, d_eager):
        assert torch.equal(a, b)
    assert d_graph[-1].shape == (5, 64, 96)


@pytest.mark.gpu
def test_captured_step_guards(deterministic):
    """A captured train step bound to one state refuses another; a restore
    (which replaces Adam's moments) makes the next call capture again,
    and the run equals one never interrupted."""
    import copy
    import tempfile

    from monodepth_tpu_torch.training.checkpoint import Checkpointer

    cfg = Config(**GRAPH_CFG)
    batches = _graph_batches(5)
    state = create_state(cfg, build_model(cfg), steps_per_epoch=4)
    twin = copy.deepcopy(state)
    step = make_train_step(state.model, cfg)
    for b in batches[:3]:
        step(state, b)
    with pytest.raises(ValueError, match="bound to the TrainState"):
        step(twin, batches[0])
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(0, state)
        for b in batches[3:]:  # the uninterrupted run
            step(state, b)
        Checkpointer(tmp).restore(twin)
        resumed = make_train_step(twin.model, cfg)
        for b in batches[:2]:  # warm up and capture on the restored state
            resumed(twin, b)
        Checkpointer(tmp).restore(twin)  # moments replaced under the capture
        for b in batches[3:]:
            resumed(twin, b)
    torch.cuda.synchronize()
    _assert_train_states_equal(state, twin)


NCCL_WIRINGS = {  # the 2-rank NCCL card test: name -> Config fields
    "separate": {},
    "separate, --remat": {"remat": True},
    "posecnn, frames (0, -1, 1, s)": {"pose_type": "posecnn", "frame_ids": (0, -1, 1, "s")},
}


def _nccl_graph_rank(arg) -> None:
    """One of 2 NCCL ranks, one card each (`run_steps.spawn` target, arg
    (out_dir, a key of NCCL_WIRINGS)): a `{data: 2}` mesh at 64x96, global
    batch 4, bf16, cuDNN deterministic; 3 captured train calls and 3 eager
    mesh steps from one state, then 3 captured and 3 eager eval calls with
    ground truth; writes out_dir/rank<r>.pt with the metrics, the states
    and the launches."""
    import copy
    import gc
    import os

    import torch.distributed as dist

    from monodepth_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        shard_batch,
        warm_collectives,
    )
    from monodepth_tpu_torch.parallel.run_steps import host_batches

    out_dir, wiring = arg
    init_distributed("cuda", timeout_s=120)
    mesh = make_mesh(2, 1, "cuda")
    warm_collectives(mesh)
    torch.backends.cudnn.deterministic = True
    cfg = Config(**dict(GRAPH_CFG, batch=4, **NCCL_WIRINGS[wiring]))
    pieces = [shard_batch(mesh, b) for b in host_batches(cfg, 3, np.float32)]
    state = create_state(cfg, build_model(cfg), steps_per_epoch=4)
    twin = copy.deepcopy(state)
    out = {"backend": dist.get_backend()}
    for name, s, graph in (("graphed", state, None), ("eager", twin, False)):
        train = make_train_step(s.model, cfg, mesh=mesh, graph=graph)
        evaluate = make_eval_step(s.model, cfg, mesh=mesh, graph=graph)
        before = _counts()
        metrics = [train(s, {k: v for k, v in p.items() if k != "depth_gt"})
                   for p in pieces]
        metrics += [evaluate(s, p, i) for i, p in enumerate(pieces)]
        torch.cuda.synchronize()
        out[name] = {"metrics": [{k: v.cpu() for k, v in m.items()} for m in metrics],
                     "launches": tuple(a - b for a, b in zip(_counts(), before)),
                     "state": {k: v.cpu() for k, v in s.model.state_dict().items()},
                     "adam": [{k: v.cpu() for k, v in e.items()}
                              for e in s.optimizer.state.values()],
                     "step": s.step}
        del train, evaluate  # no CUDA graph with NCCL inside outlives the group
        gc.collect()
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("wiring", list(NCCL_WIRINGS))
def test_captured_mesh_steps_equal_eager_over_nccl(cuda, tmp_path, wiring):
    """On a `{data: 2}` mesh over NCCL (a rank a card) the captured train
    and eval steps, their synced batch norm, gradient all-reduce, Adam with
    its rate tensor and metric reductions inside the graph, equal the
    eager mesh steps: max |diff| 0 over metrics (the eval's GT metrics
    gathered), parameters, buffers and Adam state on both ranks, for the
    default wiring, with --remat (synced batch norm's all-reduces issued
    again in the backward's recomputation) and for `posecnn` with the
    stereo frame; K1-bwd and K2 once a warp, K1 twice with --remat,
    counted on both paths."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: NCCL puts one rank on each card")
    from monodepth_tpu_torch.parallel.run_steps import spawn

    cfg = Config(**dict(GRAPH_CFG, **NCCL_WIRINGS[wiring]))
    warps = 3 * len(cfg.source_frame_ids) * len(cfg.scales)  # 3 calls
    codes = spawn(_nccl_graph_rank, 2, (str(tmp_path), wiring), deadline_s=400)
    assert codes == [0, 0], codes
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        graphed, eager = got["graphed"], got["eager"]
        assert got["backend"] == "nccl"
        assert graphed["launches"] == eager["launches"] \
            == (warps, warps * (2 if cfg.remat else 1), warps)
        assert graphed["step"] == eager["step"] == 3
        for a, b in zip(graphed["metrics"], eager["metrics"]):
            assert a.keys() == b.keys()
            for key in a:
                assert torch.equal(a[key], b[key]), (r, key)
        assert "abs_rel" in graphed["metrics"][-1]
        for key, value in graphed["state"].items():
            assert torch.equal(value, eager["state"][key]), (r, key)
        for a, b in zip(graphed["adam"], eager["adam"]):
            for key in a:
                assert torch.equal(a[key], b[key]), (r, key)


# --- a spatial mesh in one dispatch: every captured warp on the gathered rows

@pytest.mark.gpu
@pytest.mark.parametrize("train", [True, False])
def test_captured_spatial_warp_equals_the_slab_on_one_card(cuda, train):
    """The captured steps' spatial warp (`spatial_fallback`: all-gather,
    then K3) captured in a one-rank NCCL world (its all-gather a copy),
    64x96 b2, halo 16: a replay equals the eager slab warp and the eager
    gather (max |diff| 0 over out and the grid's gradient), counts one
    `spatial_fallback`, one K3 and, in the train form, one K1-bwd, and its
    profile shows those kernels and no synchronize or device-to-host copy
    (`chip_smoke.py` phase 6d at the headline shape)."""
    import torch.distributed as dist

    import chip_smoke
    from monodepth_tpu_torch.ops.cuda import warp_sample as ws

    store = dist.TCPStore("localhost", 0, 1, is_master=True, wait_for_workers=False)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        r = chip_smoke.spatial_gather_replays(torch, ws, train, B=2, H=64, W=96, halo=16)
    finally:
        dist.destroy_process_group()
    assert all(v == 0 for d in r["max_abs_diff"].values() for v in d.values()), r
    k3 = "warp_sample_grads_shifted" if train else "warp_sample_shifted"
    want = {k: 0 for k in r["replay"]}
    want.update({"spatial_fallback.calls": 1, f"{k3}.launches": 1,
                 "grid_vjp.launches": int(train)})
    assert r["replay"] == want, r
    trace = r["trace"]
    assert trace["graph_launches_in_call"] >= 1, trace
    assert trace["warp_kernels"] == ({"warp_sample_fwd_grads_kernel": 1,
                                      "warp_sample_bwd_grid_kernel": 1} if train
                                     else {"warp_sample_fwd_kernel": 1}), trace
    assert not trace["synchronize_calls_in_call"], trace
    assert not trace["device_to_host_copies"], trace


SPATIAL_FIELDS = {  # the 2-rank spatial card test: field -> Config fields
    "smooth": {"spatial_halo": 16},   # the seeded init: every eager warp on its slab
    "halo 0": {"spatial_halo": 0},    # every warp exact
    # stereo_T lifted 0.5 up: the 4 "s" eager warps of a step exact, the 8
    # others on their slabs
    "mixed": {"spatial_halo": 16, "frame_ids": (0, -1, 1, "s")},
    # each train warp's forward, its all-gather too, captured again in the
    # backward
    "smooth, --remat": {"spatial_halo": 16, "remat": True},
}


def _spatial_graph_rank(arg) -> None:
    """One of 2 NCCL ranks, one card each (`run_steps.spawn` target, arg
    (out_dir, a key of SPATIAL_FIELDS)): a `{spatial: 2}` mesh at 64x96,
    global batch 4, bf16, cuDNN deterministic; 3 captured train calls, then
    3 eval calls with ground truth, against the eager mesh steps from one
    state; writes out_dir/rank<r>.pt with the metrics, the states, the
    launches and the slab and exact warps of each path."""
    import copy
    import gc
    import os

    import torch.distributed as dist

    import chip_smoke
    from monodepth_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        shard_batch,
        warm_collectives,
    )
    from monodepth_tpu_torch.parallel.run_steps import host_batches
    from monodepth_tpu_torch.training.step import local_warp, spatial_fallback

    out_dir, field = arg
    init_distributed("cuda", timeout_s=120)
    mesh = make_mesh(1, 2, "cuda")
    warm_collectives(mesh)
    torch.backends.cudnn.deterministic = True
    cfg = Config(**dict(GRAPH_CFG, batch=4, **SPATIAL_FIELDS[field]))
    batches = chip_smoke.lifted_stereo(cfg, host_batches(cfg, 3, np.float32), 1)
    pieces = [shard_batch(mesh, b) for b in batches]
    state = create_state(cfg, build_model(cfg), steps_per_epoch=4)
    twin = copy.deepcopy(state)
    out = {"backend": dist.get_backend()}

    def counts():
        return _counts() + (warp_sample_grads_shifted.launches,
                            warp_sample_shifted.launches, local_warp.calls,
                            spatial_fallback.calls)

    for name, s, graph in (("graphed", state, None), ("eager", twin, False)):
        train = make_train_step(s.model, cfg, mesh=mesh, graph=graph)
        evaluate = make_eval_step(s.model, cfg, mesh=mesh, graph=graph)
        before = counts()
        metrics = [train(s, {k: v for k, v in p.items() if k != "depth_gt"})
                   for p in pieces]
        metrics += [evaluate(s, p, i) for i, p in enumerate(pieces)]
        torch.cuda.synchronize()
        out[name] = {"metrics": [{k: v.cpu() for k, v in m.items()} for m in metrics],
                     "counts": tuple(a - b for a, b in zip(counts(), before)),
                     "state": {k: v.cpu() for k, v in s.model.state_dict().items()},
                     "adam": [{k: v.cpu() for k, v in e.items()}
                              for e in s.optimizer.state.values()],
                     "step": s.step}
        del train, evaluate  # no CUDA graph with NCCL inside outlives the group
        gc.collect()
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("field", list(SPATIAL_FIELDS))
def test_captured_spatial_steps_equal_eager_over_nccl(cuda, tmp_path, field):
    """On a `{spatial: 2}` mesh over NCCL (a rank a card) the captured
    train and eval steps, every warp on the group's gathered rows, equal
    the eager mesh steps, which branch on the host: max |diff| 0 over
    metrics, parameters, buffers and Adam state on both ranks, on a field
    whose eager warps all stay in their slabs (also with --remat, whose
    backward captures each train warp's gather again), one (halo 0) whose
    warps all go exact, and one whose stereo warps alone go exact. Both
    paths launch one K3 a warp and one K1-bwd a train warp, no K1 or K2;
    every captured warp is exact, the eager ones as the field says."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: NCCL puts one rank on each card")
    from monodepth_tpu_torch.parallel.run_steps import spawn

    cfg = Config(**dict(GRAPH_CFG, **SPATIAL_FIELDS[field]))
    w = len(cfg.source_frame_ids) * len(cfg.scales)
    exact = {"halo 0": w, "mixed": len(cfg.scales)}.get(field, 0)
    r = 2 if cfg.remat else 1  # the train warps' forwards run twice
    codes = spawn(_spatial_graph_rank, 2, (str(tmp_path), field), deadline_s=400)
    assert codes == [0, 0], codes
    # (K2, K1, K1-bwd, K3 train, K3 eval, slab warps, exact warps) over 3
    # train and 3 eval calls
    kernels = (0, 0, 3 * w, 3 * w * r, 3 * w)
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        graphed, eager = got["graphed"], got["eager"]
        assert got["backend"] == "nccl"
        assert graphed["counts"] == kernels + (0, 3 * w * (r + 1)), (rank, graphed["counts"])
        assert eager["counts"] == kernels + (3 * (w - exact) * (r + 1),
                                             3 * exact * (r + 1)), (rank, eager["counts"])
        assert graphed["step"] == eager["step"] == 3
        for a, b in zip(graphed["metrics"], eager["metrics"]):
            assert a.keys() == b.keys()
            for key in a:
                assert torch.equal(a[key], b[key]), (rank, key)
        assert "abs_rel" in graphed["metrics"][-1]
        for key, value in graphed["state"].items():
            assert torch.equal(value, eager["state"][key]), (rank, key)
        for a, b in zip(graphed["adam"], eager["adam"]):
            for key in a:
                assert torch.equal(a[key], b[key]), (rank, key)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["smooth", "wild", "nan"])
def test_k3_on_the_gathered_rows_matches_plain(cuda, kind):
    """K3 on the whole image (row0 0) at a {spatial: 2} rank's grid rows,
    the exact warp's launch: within 1e-6 of its plain version, NaN where
    it has NaN, equal to those rows of K1's whole warp, and on the smooth
    field equal to its launch on the rank's halo-16 slab."""
    rng = np.random.default_rng(7)
    B, H, W, halo = 2, 64, 96, 16
    img = torch.from_numpy(rng.uniform(size=(B, H, W, 3)).astype(np.float32)).to(cuda)
    grid = torch.from_numpy(_field(rng, B, H, W, kind)).to(cuda)
    whole = warp_sample_grads(img, grid)
    pad = torch.zeros(B, halo, W, 3, device=cuda)
    padded = torch.cat([pad, img, pad], 1)
    for s in range(2):
        rows = grid[:, s * 32:(s + 1) * 32].contiguous()
        got = (warp_sample_shifted(img, rows, 0, H),) + warp_sample_grads_shifted(img, rows, 0, H)
        want = (warp_sample_shifted_reference(img, rows, 0, H),) + \
            warp_sample_grads_shifted_reference(img, rows, 0, H)
        for a, b in zip(got, want):
            assert torch.equal(a.isnan(), b.isnan())
            assert float((a - b).nan_to_num().abs().max()) <= 1e-6, (kind, s)
        for a, b in zip(got[1:], whole):
            assert torch.equal(a.nan_to_num(), b[:, s * 32:(s + 1) * 32].nan_to_num())
        if kind == "smooth":
            slab = padded[:, s * 32:s * 32 + 32 + 2 * halo].contiguous()
            on_slab = warp_sample_grads_shifted(slab, rows, s * 32 - halo, H)
            for a, b in zip(on_slab, got[1:]):
                assert torch.equal(a, b), s
