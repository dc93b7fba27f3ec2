"""The port on the card: each CUDA kernel (the warp sampler's, its
backward K1-bwd, its shifted slab form K3, and the warp-gather probes')
against its plain PyTorch version, the launches of the eval and train
steps (with --remat too), and `prefetch_to_device`'s batches on the card. Marked `gpu`; each test skips without a
CUDA device. This file imports neither jax nor the JAX package and uses no
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


@pytest.mark.gpu
def test_eval_step_on_card_matches_cpu(cuda):
    """f32, small: the card's eval step (8 kernel launches) against the CPU
    step (plain warp) on the same weights, batch and noise. TF32 is off
    under f32, so only summation order separates the two."""
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
    before = warp_sample.launches
    card = make_eval_step(model, cfg)(create_state(cfg, model), batch,
                                      noise=noise)
    assert warp_sample.launches == before + 8
    np.testing.assert_allclose(float(card["loss"]), float(cpu["loss"]), rtol=1e-4)
    assert float(card["warp_span"]) == pytest.approx(float(cpu["warp_span"]),
                                                     abs=0.125)


@pytest.mark.gpu
def test_train_step_launches_k1_eight_times(cuda):
    """f32, small: one train step on the card launches K1 and K1-bwd once
    per warp (2 sources x 4 scales) and K2 never, and its loss agrees with the CPU
    step's (plain warp) from the same weights, batch and noise."""
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
    card = make_train_step(model, cfg)(create_state(cfg, model, steps_per_epoch=10),
                                       batch, noise=noise)
    torch.cuda.synchronize()
    assert (warp_sample.launches, warp_sample_grads.launches, grid_vjp.launches) == \
        (before[0], before[1] + 8, before[2] + 8)
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
