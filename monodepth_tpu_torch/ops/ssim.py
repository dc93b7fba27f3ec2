"""SSIM and the SSIM+L1 photometric error, NHWC, plain torch
(reference: model_loss/model_loss.py:11-41, 92-103)."""

from __future__ import annotations

import torch

from monodepth_tpu_torch.ops.sampling import clip
from monodepth_tpu_torch.parallel import rows

Tensor = torch.Tensor

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _reflect_pad_w(x: Tensor) -> Tensor:
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def _sum3(x: Tensor) -> Tensor:
    """3x3 mean over a padded NHWC tensor (output 2 smaller each way)."""
    x = x[:, :-2] + x[:, 1:-1] + x[:, 2:]
    x = x[:, :, :-2] + x[:, :, 1:-1] + x[:, :, 2:]
    return x * (1.0 / 9.0)


def _avg_pool3(x: Tensor, halo) -> Tensor:
    """3x3 mean over NHWC `x` reflect-padded (output size == input): its
    rows padded with `halo` (top, bottom), or with its own rows 1 and H-2
    where `halo` is None."""
    top, bottom = halo if halo is not None else (x[:, 1:2], x[:, -2:-1])
    return _sum3(_reflect_pad_w(torch.cat([top, x, bottom], dim=1)))


def _times(a, b):
    return None if a is None else (a[0] * b[0], a[1] * b[1])


def ssim(image1: Tensor, image2: Tensor) -> Tensor:
    """Per-pixel SSIM distance clip((1 - SSIM)/2, 0, 1), NHWC in and out.
    The distance is 0 exactly wherever two 3x3 patches match, so the clip
    passes half the gradient there, as `jnp.clip` does. The 3x3 windows
    reflect at the image's edges. On row pieces (`parallel.rows`) each
    input's reflected or neighbour row a side is exchanged once, and each
    pooled product is padded with the product of those rows, so no padded
    copy of a full-size input is kept for the backward."""
    x, y = rows.reflect_halo(image1, 1), rows.reflect_halo(image2, 1)
    mu_x = _avg_pool3(image1, x)
    mu_y = _avg_pool3(image2, y)

    sigma_x = _avg_pool3(image1 * image1, _times(x, x)) - mu_x * mu_x
    sigma_y = _avg_pool3(image2 * image2, _times(y, y)) - mu_y * mu_y
    sigma_xy = _avg_pool3(image1 * image2, _times(x, y)) - mu_x * mu_y
    return _distance(mu_x, mu_y, sigma_x, sigma_y, sigma_xy)


def _distance(mu_x, mu_y, sigma_x, sigma_y, sigma_xy) -> Tensor:
    num = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    den = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return clip((1.0 - num / den) * 0.5, 0.0, 1.0)


def reprojection_error(prediction: Tensor, target: Tensor) -> Tensor:
    """0.85 * mean_c(SSIM) + 0.15 * mean_c(L1) -> [B, H, W, 1]."""
    l1 = torch.abs(target - prediction).mean(-1, keepdim=True)
    ssim_term = ssim(prediction, target).mean(-1, keepdim=True)
    return 0.85 * ssim_term + 0.15 * l1
