"""Inputs made from the seed, on the device, in a few large calls.

`planar_scenes` renders multi-view scenes of a slanted textured plane,
after the port's `data.synthetic.make_planar_scenes` (copied here, in bulk
on the device, so that the benchmark's inputs do not move with the
program): the inverse depth is linear in the pixel coordinates, and the
source views are the target's texture shifted along x by a camera
translation: frames -1 and +1 by one sized so that the largest shift is
`max_shift_px`, the stereo frame "s" by a baseline drawn apart
(`stereo_baselines`). Each sample is flipped and jittered as the KITTI
loader draws it. KITTI's normalised intrinsics give K.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

VIEWS = (0, -1, 1, "s")
NORMALIZED_K = ((0.58, 0.0, 0.5, 0.0), (0.0, 1.92, 0.5, 0.0),
                (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def generator(seed: int, purpose: int, device) -> torch.Generator:
    """A generator on `device` for one purpose of one run's seed (any
    non-negative integer, of any size)."""
    key = np.random.SeedSequence([int(seed), purpose]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(key[0]) << 32 | int(key[1]))


def intrinsics(n: int, height: int, width: int, device) -> Dict[str, Tensor]:
    K = torch.tensor(NORMALIZED_K, dtype=torch.float64)
    K[0] *= width
    K[1] *= height
    inv = torch.linalg.inv(K)
    return {"K": K.float().to(device).expand(n, 4, 4).contiguous(),
            "inv_K": inv.float().to(device).expand(n, 4, 4).contiguous()}


def _texture(g: torch.Generator, n: int, height: int, width: int, cell: int,
             device) -> Tensor:
    """Multi-octave random RGB texture in about [0.05, 0.95], [n, 3, H, W]."""
    img = torch.zeros(n, 3, height, width, device=device)
    weight, total, c = 1.0, 0.0, max(cell * 16, 16)
    while c >= cell:
        small = torch.rand(n, 3, height // c + 2, width // c + 2, generator=g, device=device)
        img += weight * F.interpolate(small, (height, width), mode="bilinear",
                                      align_corners=False)
        total += weight
        weight *= 0.55
        c //= 4
    return 0.05 + 0.9 * img / total


def planar_scenes(g: torch.Generator, n: int, height: int, width: int,
                  max_shift_px: float, texture_cell: int, device,
                  frame_ids=(0, -1, 1), baseline: Tensor | None = None,
                  keep: dict | None = None) -> Dict[str, Tensor]:
    """n scenes -> frames uint8 [n, F, H, W, 3] in the order of `frame_ids`
    (of 0, -1, 1 and "s"), jitter [n, 5] and K, inv_K [n, 4, 4] and, with
    "s", stereo_T [n, 4, 4], on `device`. `baseline` [n], needed with "s":
    the stereo view's translation over the temporal views'. `keep`, when
    given, gets each scene's inverse depth [n, H, W] as "disp", flipped
    with its frames."""
    if not set(frame_ids) <= set(VIEWS) or frame_ids[0] != 0:
        raise ValueError(f"planar scenes render frames {VIEWS}, the target first: {frame_ids}")
    u = lambda *shape: torch.rand(*shape, generator=g, device=device)  # noqa: E731
    sign = lambda *shape: torch.where(u(*shape) < 0.5, -1.0, 1.0)  # noqa: E731
    cam = intrinsics(n, height, width, device)
    fx = NORMALIZED_K[0][0] * width
    xs = torch.arange(width, device=device, dtype=torch.float32)
    ys = torch.arange(height, device=device, dtype=torch.float32)
    a = 3.5 + 3.0 * u(n)
    b = sign(n) * (0.15 + 0.25 * u(n)) * a / width
    c = sign(n) * (0.15 + 0.25 * u(n)) * a / height
    d = a[:, None, None] + b[:, None, None] * xs + c[:, None, None] * ys[:, None]
    tx = sign(n) * max_shift_px / (fx * d.amax((1, 2)))

    tex = _texture(g, n, height, width, texture_cell, device)
    lo, hi = d.amin((1, 2), keepdim=True), d.amax((1, 2), keepdim=True)
    tint = 0.1 + 0.8 * (d - lo) / (hi - lo + 1e-9)
    tex[:, 0] = 0.6 * tex[:, 0] + 0.4 * tint

    # a view translated by t along x shows the target's pixel (x, y) at
    # x + fx·t·d(x, y): render it by the inverse of that map, row by row
    shifts = {-1: fx * tx * -1.0, 1: fx * tx * 1.0}
    if "s" in frame_ids:
        stereo_tx = baseline * tx.abs()
        shifts["s"] = fx * stereo_tx
    views = {0: tex}
    for fid, shift in shifts.items():
        s = shift[:, None, None]
        x = (xs - s * c[:, None, None] * ys[:, None] - s * a[:, None, None]) \
            / (1.0 + s * b[:, None, None])
        x = x.clamp(0, width - 1)
        x0 = x.floor().long().clamp(max=width - 2)
        w1 = (x - x0)[:, None]
        take = lambda i: tex.gather(3, i[:, None].expand(-1, 3, -1, -1))  # noqa: E731
        views[fid] = take(x0) * (1 - w1) + take(x0 + 1) * w1
    frames = torch.stack([views[f] for f in frame_ids], 1)          # [n, F, 3, H, W]
    flip = u(n) > 0.5
    frames = torch.where(flip[:, None, None, None, None], frames.flip(-1), frames)
    frames = (frames * 255 + 0.5).clamp(0, 255).to(torch.uint8)
    apply = (u(n) > 0.5).float()
    jitter = torch.stack([apply, 0.8 + 0.4 * u(n), 0.8 + 0.4 * u(n), 0.8 + 0.4 * u(n),
                          -0.1 + 0.2 * u(n)], 1)
    out = {"frames": frames.permute(0, 1, 3, 4, 2).contiguous(), "jitter": jitter, **cam}
    if "s" in frame_ids:
        # a flip mirrors the baseline, as Monodepth2's loader negates it
        T = torch.eye(4, device=device).repeat(n, 1, 1)
        T[:, 0, 3] = torch.where(flip, -stereo_tx, stereo_tx)
        out["stereo_T"] = T
    if keep is not None:
        keep["disp"] = torch.where(flip[:, None, None], d.flip(-1), d)
    return out


def stereo_baselines(g: torch.Generator, n: int, device) -> Tensor:
    """n stereo baselines over the temporal views' translation: either
    camera of the pair as the target (the sign), 0.5 to 1 times as far."""
    side = torch.where(torch.rand(n, generator=g, device=device) < 0.5, -1.0, 1.0)
    return side * (0.5 + 0.5 * torch.rand(n, generator=g, device=device))


def tie_noise(g: torch.Generator, n: int, height: int, width: int, sources: int,
              scales, device) -> Dict[int, Tensor]:
    """The automask's tie-break noise of one step, 1e-5·N(0, 1)
    {scale: [n, H, W, sources]}."""
    return {s: 1e-5 * torch.randn(n, height, width, sources, generator=g, device=device)
            for s in scales}
