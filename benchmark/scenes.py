"""Inputs made from the seed, on the device, in a few large calls.

`planar_scenes` renders multi-view scenes of a slanted textured plane,
after the port's `data.synthetic.make_planar_scenes` (copied here, in bulk
on the device, so that the benchmark's inputs do not move with the
program): the inverse depth is linear in the pixel coordinates, and the two
source views are the target's texture shifted along x by a camera
translation sized so that the largest shift is `max_shift_px`. Each sample
is flipped and jittered as the KITTI loader draws it. KITTI's normalised
intrinsics give K.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

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
                  max_shift_px: float, texture_cell: int, device) -> Dict[str, Tensor]:
    """n scenes -> frames uint8 [n, 3, H, W, 3] (frames 0, -1, +1), jitter
    [n, 5] and K, inv_K [n, 4, 4], on `device`."""
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

    views = [tex]
    for direction in (-1.0, 1.0):
        s = (fx * tx * direction)[:, None, None]
        x = (xs - s * c[:, None, None] * ys[:, None] - s * a[:, None, None]) \
            / (1.0 + s * b[:, None, None])
        x = x.clamp(0, width - 1)
        x0 = x.floor().long().clamp(max=width - 2)
        w1 = (x - x0)[:, None]
        take = lambda i: tex.gather(3, i[:, None].expand(-1, 3, -1, -1))  # noqa: E731
        views.append(take(x0) * (1 - w1) + take(x0 + 1) * w1)
    frames = torch.stack(views, 1)                                   # [n, 3, 3, H, W]
    flip = u(n) > 0.5
    frames = torch.where(flip[:, None, None, None, None], frames.flip(-1), frames)
    frames = (frames * 255 + 0.5).clamp(0, 255).to(torch.uint8)
    apply = (u(n) > 0.5).float()
    jitter = torch.stack([apply, 0.8 + 0.4 * u(n), 0.8 + 0.4 * u(n), 0.8 + 0.4 * u(n),
                          -0.1 + 0.2 * u(n)], 1)
    return {"frames": frames.permute(0, 1, 3, 4, 2).contiguous(), "jitter": jitter, **cam}


def tie_noise(g: torch.Generator, n: int, height: int, width: int, sources: int,
              scales, device) -> Dict[int, Tensor]:
    """The automask's tie-break noise of one step, 1e-5·N(0, 1)
    {scale: [n, H, W, sources]}."""
    return {s: 1e-5 * torch.randn(n, height, width, sources, generator=g, device=device)
            for s in scales}
