"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the launches of the eval and train steps. Marked `gpu`; each test skips without a
CUDA device. This file imports neither jax nor the JAX package and uses no
conftest fixture, so the host with the card runs it on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    WarpSample,
    warp_sample,
    warp_sample_grads,
    warp_sample_grads_reference,
    warp_sample_reference,
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
    """`WarpSample` through K1 against the same backward from the plain
    forward: max |diff| <= 1e-6 · max(scale, 1)."""
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
    """f32, small: one train step on the card launches K1 once per warp
    (2 sources x 4 scales) and K2 never, and its loss agrees with the CPU
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
    before = (warp_sample.launches, warp_sample_grads.launches)
    card = make_train_step(model, cfg)(create_state(cfg, model, steps_per_epoch=10),
                                       batch, noise=noise)
    torch.cuda.synchronize()
    assert (warp_sample.launches, warp_sample_grads.launches) == \
        (before[0], before[1] + 8)
    np.testing.assert_allclose(float(card["loss"]), float(cpu["loss"]), rtol=1e-4)


@pytest.mark.gpu
def test_train_step_is_deterministic(cuda):
    """bf16 at the headline width, small batch: two train steps from one
    state, the kernel warp in one and the plain warp in the other, give
    the same loss and bit-identical gradients."""
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
