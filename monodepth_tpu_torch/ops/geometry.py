"""View-synthesis geometry as plain torch ops, NHWC at the interface.

Counterpart of `monodepth_tpu.ops.geometry` (reference:
model_layer/warp.py:29-153, 193-269). The products run in full f32:
`training.state.build_model` turns TF32 matmuls off.
"""

from __future__ import annotations

import torch

from monodepth_tpu_torch.ops.sampling import device_constant

Tensor = torch.Tensor


def disparity_to_depth(disparity: Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth), with
    depth = 1 / (1/max_depth + (1/min_depth - 1/max_depth) * d)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disparity
    return scaled_disp, 1.0 / scaled_disp


def axis_angle_to_rotation(axisangle: Tensor) -> Tensor:
    """Rodrigues axis-angle [B, 3] -> [B, 4, 4] rotation matrices. The axis
    is normalized by (|v| + 1e-5), the reference's numerical guard."""
    axisangle = axisangle.reshape(-1, 3)
    angle = torch.linalg.vector_norm(axisangle, ord=2, dim=-1, keepdim=True)
    axis = axisangle / (angle + 1e-5)

    cos = torch.cos(angle)[..., 0]
    sin = torch.sin(angle)[..., 0]
    C = 1.0 - cos

    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    xs, ys, zs = x * sin, y * sin, z * sin
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC

    zero = torch.zeros_like(cos)
    one = torch.ones_like(cos)
    return torch.stack([
        x * xC + cos, xyC - zs,     zxC + ys,     zero,
        xyC + zs,     y * yC + cos, yzC - xs,     zero,
        zxC - ys,     yzC + xs,     z * zC + cos, zero,
        zero,         zero,         zero,         one,
    ], -1).reshape(-1, 4, 4)


def translation_to_matrix(translation: Tensor) -> Tensor:
    """[B, 3] translation -> [B, 4, 4] homogeneous translation matrix."""
    translation = translation.reshape(-1, 3)
    T = torch.eye(4, dtype=translation.dtype, device=translation.device)
    T = T.repeat(translation.shape[0], 1, 1)
    T[:, :3, 3] = translation
    return T


def transform_from_parameters(axisangle: Tensor, translation: Tensor,
                              invert: bool = False) -> Tensor:
    """(axis-angle, translation) -> [B, 4, 4] camera-to-camera transform.

    invert=True (source frame before the target):  M = R^T @ T(-t)
    invert=False:                                   M = T(t) @ R
    """
    R = axis_angle_to_rotation(axisangle)
    t = translation.reshape(-1, 3)
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = translation_to_matrix(t)
    return R @ T if invert else T @ R


def _homogeneous_pixel_grid(height: int, width: int, dtype, device,
                            row0: int = 0) -> Tensor:
    """[3, H*W] rows = (x, y, 1), y from the global row `row0`."""
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1)
    return pix.to(dtype)


def warp_grid(depth: Tensor, inv_K: Tensor, K: Tensor, T: Tensor,
              row0: int = 0, full_height: int | None = None) -> Tensor:
    """Fused backproject∘project: depth [B,H,W(,1)] + intrinsics + SE(3)
    -> normalized [-1, 1] sample grid [B, H, W, 2] (align_corners=True).

        pts = (K T)[:3] @ [depth * (inv_K[:3,:3] @ pix); 1]
            = A @ pix * depth + P[:, 3:]     with A = (K T)[:3, :3] inv_K[:3,:3]

    With `full_height`, `depth` holds the rows from the global row `row0`
    of an image `full_height` rows high (a spatial mesh's row piece), and
    the grid of those rows comes out in the whole image's coordinates.
    """
    if depth.ndim == 4:
        depth = depth[..., 0]
    B, H, W = depth.shape
    pix = _homogeneous_pixel_grid(H, W, depth.dtype, depth.device, row0)

    P = (K @ T)[:, :3, :]                               # [B,3,4]
    A = P[:, :, :3] @ inv_K[:, :3, :3]                  # [B,3,3]
    rays = torch.einsum("bij,jn->bin", A, pix)          # [B,3,HW]
    pts = rays * depth.reshape(B, 1, H * W) + P[:, :, 3:4]
    xy = pts[:, :2, :] / (pts[:, 2:3, :] + 1e-7)
    xy = xy.reshape(B, 2, H, W).permute(0, 2, 3, 1)
    scale = device_constant((W - 1, (full_height or H) - 1), xy.dtype, xy.device)
    return ((xy / scale - 0.5) * 2.0).contiguous()
