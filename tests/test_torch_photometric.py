"""The photometric term's plain versions (`ops/cuda/photometric.py`), what
the CPU runs and the card's kernels are held to: `identity_errors` and
`photometric_min` equal `monodepth_loss`'s composition (`reprojection_error`,
`torch.cat`, `+ noise`, `amin`) in f64, values and warp gradients bit for
bit, over 1-3 sources, automasking on and off, planted exact ties, a NaN
pixel and odd shapes down to 3x3; the mask's lowest bit is argmin's index
and its split of the cotangent is amin's autograd; `monodepth_loss` with
the kernels' module equals it without. Torch only; no card.
"""

import pytest
import torch

from monodepth_tpu_torch.losses.reprojection import min_reprojection, monodepth_loss
from monodepth_tpu_torch.ops.cuda import photometric as ph
from monodepth_tpu_torch.ops.ssim import reprojection_error

SHAPES = [(2, 3, 3), (1, 5, 7), (2, 16, 24)]
KINDS = ["plain", "tie_reprojections", "tie_identity", "nan"]
CASES = [(shape, F, automask, kind) for shape in SHAPES for F in (1, 2, 3)
         for automask in (True, False) for kind in KINDS
         if not (kind == "tie_reprojections" and F == 1)
         and not (kind == "tie_identity" and not automask)]


def _images(shape, F, automask, kind, seed=0):
    """(warps, sources, target, noise) in f64; the kinds plant an exact tie
    of two reprojections (two equal warps), of the first identity channel
    and the first reprojection (the source equals its warp, no noise), or a
    NaN in the first warp."""
    B, H, W = shape
    g = torch.Generator().manual_seed(seed)
    target = torch.rand(B, H, W, 3, generator=g, dtype=torch.float64)
    warps = [0.6 * torch.rand(B, H, W, 3, generator=g, dtype=torch.float64) + 0.3 * target
             for _ in range(F)]
    sources = [torch.rand(B, H, W, 3, generator=g, dtype=torch.float64) for _ in range(F)]
    noise = 1e-5 * torch.randn(B, H, W, F, generator=g, dtype=torch.float64)
    if kind == "tie_reprojections":
        warps[1] = warps[0].clone()
    elif kind == "tie_identity":
        sources[0] = warps[0].clone()
        noise.zero_()
    elif kind == "nan":
        warps[0][0, H // 2, W // 2, 1] = float("nan")
    return warps, sources, target, noise if automask else None


def _composition(warps, sources, target, noise):
    """`monodepth_loss`'s photometric minimum of one scale, as it composes it."""
    identity = None
    if noise is not None:
        identity = torch.cat([reprojection_error(s, target) for s in sources], -1)
    reproj = torch.cat([reprojection_error(w, target) for w in warps], -1)
    combined = reproj if identity is None else torch.cat([identity + noise, reproj], -1)
    return min_reprojection(reproj, identity, noise), combined.detach()


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("shape,F,automask,kind", CASES)
def test_plain_photometric_min_is_the_composition(shape, F, automask, kind):
    warps, sources, target, noise = _images(shape, F, automask, kind)
    mine = [w.clone().requires_grad_(True) for w in warps]
    theirs = [w.clone().requires_grad_(True) for w in warps]
    identity = ph.identity_errors(sources, target) if automask else None
    minimum, mask = ph.photometric_min(mine, target, identity, noise)
    want, combined = _composition(theirs, sources, target, noise)
    _same(minimum, want)
    if automask:
        _same(identity, torch.cat([reprojection_error(s, target) for s in sources], -1))
    if kind == "tie_reprojections":
        assert bool(((mask >> (F if automask else 0)) & 3 == 3).any())
    if kind == "tie_identity":
        assert bool((mask & 1).bool().logical_and((mask >> F) & 1 == 1).any())
    if kind == "nan":
        assert bool(minimum.isnan().any()) and bool((mask[minimum.isnan()] & ph.NAN_MIN).all())
    dmin = torch.randn(minimum.shape, generator=torch.Generator().manual_seed(1),
                       dtype=torch.float64)
    minimum.backward(dmin)
    want.backward(dmin)
    for a, b in zip(mine, theirs):
        _same(a.grad, b.grad)
    # the backward kernel's plain version, from the mask alone
    for a, b in zip(ph.photometric_min_grads_reference(warps, target, mask, dmin, automask),
                    theirs):
        _same(a, b.grad)
    assert torch.equal(ph.first_choice(mask), combined.argmin(-1))


@pytest.mark.parametrize("channels", [1, 2, 4, 6])
@pytest.mark.parametrize("kind", ["plain", "ties", "nan"])
def test_mask_split_is_amins_autograd(channels, kind):
    """The mask of the minimum, lowest bit = argmin, and its split of the
    cotangent = amin's autograd (the even split among tied channels; NaN
    to every channel of a NaN minimum), bit for bit in f32."""
    g = torch.Generator().manual_seed(channels)
    x = torch.rand(3, 8, 10, channels, generator=g).round(decimals=1)  # ties
    if kind == "plain":
        x = torch.rand(3, 8, 10, channels, generator=g)
    elif kind == "nan":
        x[0, 1, 2, channels - 1] = float("nan")
        x[1, 2, 3, 0] = float("nan")
    x.requires_grad_(True)
    minimum = x[..., 0] if channels == 1 else x.amin(-1)
    dmin = torch.randn(minimum.shape, generator=g)
    minimum.backward(dmin)
    mask = ph.tie_mask(x.detach(), minimum.detach())
    _same(ph.mask_cotangent(mask, dmin, channels), x.grad)
    assert torch.equal(ph.first_choice(mask), x.detach().argmin(-1))
    if kind == "ties" and channels > 1:
        assert bool((x.grad.abs() > 0).sum(-1).gt(1).any())  # a split happened


@pytest.mark.parametrize("automask", [True, False])
@pytest.mark.parametrize("F", [1, 2])
def test_monodepth_loss_with_the_kernels_module_is_bit_equal(automask, F):
    """On CPU tensors `monodepth_loss(photometric=ops.cuda.photometric)` is
    the composition: loss, terms, choices and the gradients of the warps
    and disparities bit for bit, no kernel launched."""
    g = torch.Generator().manual_seed(3)
    B, H, W, scales = 2, 12, 16, (0, 1)
    target = torch.rand(B, H, W, 3, generator=g, dtype=torch.float64)
    sources = [torch.rand(B, H, W, 3, generator=g, dtype=torch.float64) for _ in range(F)]
    warps = {s: [torch.rand(B, H, W, 3, generator=g, dtype=torch.float64) for _ in range(F)]
             for s in scales}
    disps = {s: torch.rand(B, H >> s, W >> s, 1, generator=g, dtype=torch.float64)
             for s in scales}
    colors = [target, torch.rand(B, H // 2, W // 2, 3, generator=g, dtype=torch.float64)]
    noise = {s: 1e-5 * torch.randn(B, H, W, F, generator=g, dtype=torch.float64)
             for s in scales}
    before = (ph.identity_errors.launches, ph.photometric_min.launches,
              ph.photometric_min_grads.launches)
    out = []
    for module in (None, ph):
        w = {s: [t.clone().requires_grad_(True) for t in v] for s, v in warps.items()}
        d = {s: t.clone().requires_grad_(True) for s, t in disps.items()}
        loss, aux = monodepth_loss(d, w, sources, colors, noise, scales=scales,
                                   use_automasking=automask, choices=True,
                                   photometric=module)
        loss.backward()
        out.append((loss, aux, [t.grad for v in w.values() for t in v],
                    [t.grad for t in d.values()]))
    (la, aa, wa, da), (lb, ab, wb, db) = out
    assert torch.equal(la, lb)
    assert aa.keys() == ab.keys()
    for key in aa:
        assert torch.equal(aa[key], ab[key]), key
    for a, b in zip(wa + da, wb + db):
        assert torch.equal(a, b)
    assert (ph.identity_errors.launches, ph.photometric_min.launches,
            ph.photometric_min_grads.launches) == before


def test_wrappers_refuse_what_they_cannot_take():
    """The checks made before any kernel: shapes, counts, identity and noise
    together, and a device that is neither cuda nor cpu."""
    t = torch.zeros(1, 4, 5, 3)
    with pytest.raises(ValueError, match="shaped like"):
        ph.photometric_min([torch.zeros(1, 4, 6, 3)], t, None, None)
    with pytest.raises(ValueError, match="1 to 3"):
        ph.identity_errors([t] * 4, t)
    with pytest.raises(ValueError, match="together"):
        ph.photometric_min([t], t, torch.zeros(1, 4, 5, 1), None)
    meta = torch.zeros(1, 4, 5, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ph.identity_errors([meta], meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ph.photometric_min([meta], meta, None, None)


@pytest.mark.parametrize("use_pallas,device,spatial,takes", [
    (True, "cuda", None, True), (True, "cuda", 1, True), (True, "cuda", 2, False),
    (True, "cpu", None, False), (False, "cuda", None, False)])
def test_the_step_takes_the_kernels_on_a_card_only(use_pallas, device, spatial, takes):
    """`training.step._photometric`: the kernels' module where the warp
    kernels are on and the step runs on a card, except on a spatial mesh's
    row pieces; the plain composition (None) elsewhere. Nothing launches."""
    from types import SimpleNamespace

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.training import step

    mesh = None if spatial is None else SimpleNamespace(spatial=spatial)
    got = step._photometric(Config(use_pallas=use_pallas), mesh, torch.device(device))
    assert got is (ph if takes else None)


@pytest.mark.parametrize("spatial", [1, 2])
def test_a_mesh_reference_takes_the_loss_path_of_its_mesh(spatial):
    """`run_steps`' one-device reference runs its mesh's program: the
    kernels' module for a data mesh on a card, the plain composition for a
    spatial mesh (whose ranks keep it); the step's choice comes back after."""
    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.parallel import run_steps
    from monodepth_tpu_torch.training import step

    cfg, card = Config(use_pallas=True), torch.device("cuda")
    with run_steps._mesh_loss_path(spatial):
        assert step._photometric(cfg, None, card) is (ph if spatial == 1 else None)
    assert step._photometric(cfg, None, card) is ph
