"""Edge-aware disparity smoothness loss, NHWC, plain torch
(reference: model_loss/model_loss.py:45-88, 107-116)."""

from __future__ import annotations

import torch

from monodepth_tpu_torch.parallel import rows

Tensor = torch.Tensor


def edge_aware_smoothness(disparity: Tensor, image: Tensor) -> Tensor:
    """|∂d| * exp(-|∂I|) averaged over both axes -> scalar.
    disparity: [B, h, w, 1]; image: [B, h, w, 3] (same scale). On row
    pieces (`parallel.rows`) the y-gradient across a rank boundary takes
    the next rank's first row, and the result is this rank's part."""
    grad_disp_x = torch.abs(disparity[:, :, :-1, :] - disparity[:, :, 1:, :])
    disp_y, image_y = rows.with_next_row(disparity), rows.with_next_row(image)
    grad_disp_y = torch.abs(disp_y[:, :-1, :, :] - disp_y[:, 1:, :, :])

    grad_img_x = torch.abs(image[:, :, :-1, :] - image[:, :, 1:, :]).mean(-1, keepdim=True)
    grad_img_y = torch.abs(image_y[:, :-1, :, :] - image_y[:, 1:, :, :]).mean(-1, keepdim=True)

    grad_disp_x = grad_disp_x * torch.exp(-grad_img_x)
    grad_disp_y = grad_disp_y * torch.exp(-grad_img_y)
    B, h, w, _ = disparity.shape
    return rows.loss_mean(grad_disp_x) + rows.loss_mean(
        grad_disp_y, B * (rows.global_rows(h) - 1) * w)


def smooth_loss(disparity: Tensor, color: Tensor) -> Tensor:
    """Edge-aware smoothness on mean-normalized disparity."""
    mean_disp = rows.spatial_mean(disparity, (1, 2), keepdim=True)
    return edge_aware_smoothness(disparity / (mean_disp + 1e-7), color)
