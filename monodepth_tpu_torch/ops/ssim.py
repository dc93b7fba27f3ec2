"""SSIM and the SSIM+L1 photometric error, NHWC, plain torch
(reference: model_loss/model_loss.py:11-41, 92-103)."""

from __future__ import annotations

import torch

from monodepth_tpu_torch.ops.sampling import clip

Tensor = torch.Tensor

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def _reflect_pad_hw(x: Tensor) -> Tensor:
    """Reflection pad of 1 on H and W of an NHWC tensor."""
    x = torch.cat([x[:, 1:2], x, x[:, -2:-1]], dim=1)
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def _avg_pool3(x: Tensor) -> Tensor:
    """3x3 mean over a reflect-padded NHWC tensor (output size == input)."""
    x = _reflect_pad_hw(x)
    x = x[:, :-2] + x[:, 1:-1] + x[:, 2:]
    x = x[:, :, :-2] + x[:, :, 1:-1] + x[:, :, 2:]
    return x * (1.0 / 9.0)


def ssim(image1: Tensor, image2: Tensor) -> Tensor:
    """Per-pixel SSIM distance clip((1 - SSIM)/2, 0, 1), NHWC in and out.
    The distance is 0 exactly wherever two 3x3 patches match, so the clip
    passes half the gradient there, as `jnp.clip` does."""
    mu_x = _avg_pool3(image1)
    mu_y = _avg_pool3(image2)

    sigma_x = _avg_pool3(image1 * image1) - mu_x * mu_x
    sigma_y = _avg_pool3(image2 * image2) - mu_y * mu_y
    sigma_xy = _avg_pool3(image1 * image2) - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    den = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return clip((1.0 - num / den) * 0.5, 0.0, 1.0)


def reprojection_error(prediction: Tensor, target: Tensor) -> Tensor:
    """0.85 * mean_c(SSIM) + 0.15 * mean_c(L1) -> [B, H, W, 1]."""
    l1 = torch.abs(target - prediction).mean(-1, keepdim=True)
    ssim_term = ssim(prediction, target).mean(-1, keepdim=True)
    return 0.85 * ssim_term + 0.15 * l1
