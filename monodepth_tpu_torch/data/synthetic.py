"""Synthetic data with no dataset on disk (numpy + PIL): a mini KITTI raw
tree and planar scenes with exact self-supervised geometry.

Copies of `monodepth_tpu.data.synthetic`'s `make_kitti_tree`,
`make_split_files`, `make_planar_scenes` (with its texture helper) and
`spearman_rank`.
Same seed, same bytes as the JAX package's: the tree's JPEGs, scans,
calibration and split files are equal file for file.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from monodepth_tpu_torch.data import kitti

DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"

_CALIB_CAM = """calib_time: 09-Jan-2012 13:57:47
S_rect_02: 1.242000e+03 3.750000e+02
R_rect_00: 1 0 0 0 1 0 0 0 1
P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 0.000000e+00 0.000000e+00 7.215377e+02 1.728540e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00
P_rect_03: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 7.215377e+02 1.728540e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00
"""

# standard KITTI axis permutation: cam x = -velo y, cam y = -velo z,
# cam z = velo x (forward)
_CALIB_VELO = """calib_time: 15-Mar-2012 11:37:16
R: 0 -1 0 0 0 -1 1 0 0
T: 0 0 0
"""


def make_kitti_tree(root: str, num_frames: int = 6, seed: int = 0,
                    image_hw=(96, 320)) -> str:
    """Create a synthetic KITTI raw tree with `num_frames` frames in one
    drive, both cameras (smooth random JPEGs, 2000 velodyne returns a
    frame inside the camera's frustum, KITTI calibration). Returns the
    datapath root."""
    rng = np.random.default_rng(seed)
    date_dir = os.path.join(root, "2011_09_26")
    drive_dir = os.path.join(root, DRIVE)
    for sub in ("image_02/data", "image_03/data", "velodyne_points/data"):
        os.makedirs(os.path.join(drive_dir, sub), exist_ok=True)

    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        f.write(_CALIB_CAM)
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        f.write(_CALIB_VELO)

    H, W = image_hw
    for i in range(num_frames):
        # smooth random images so photometric losses behave
        small = rng.uniform(0, 255, (H // 8, W // 8, 3))
        img = np.asarray(Image.fromarray(small.astype(np.uint8)).resize(
            (W, H), Image.BILINEAR))
        for cam in ("image_02", "image_03"):
            Image.fromarray(img).save(
                os.path.join(drive_dir, cam, "data", f"{i:010d}.jpg"),
                quality=92)

        # forward-facing points that land inside the image frustum
        n = 2000
        pts = np.zeros((n, 4), dtype=np.float32)
        fwd = rng.uniform(2.0, 60.0, n)
        pts[:, 0] = fwd                                  # forward (cam z)
        pts[:, 1] = rng.uniform(-0.5, 0.5, n) * fwd      # left (cam -x)
        pts[:, 2] = rng.uniform(-0.15, 0.2, n) * fwd     # up (cam -y)
        pts[:, 3] = rng.uniform(0.0, 1.0, n)             # reflectance
        pts.tofile(os.path.join(drive_dir, "velodyne_points/data",
                                f"{i:010d}.bin"))
    return root


def make_split_files(root: str, num_frames: int = 6,
                     datatype: str = "kitti_eigen_zhou") -> str:
    """Write train/val/test split lists (middle frames only, so +-1
    neighbors exist). Returns the splits dir."""
    splits_dir = os.path.join(root, "splits", datatype)
    os.makedirs(splits_dir, exist_ok=True)
    frames = [f"{DRIVE} {i} l" for i in range(1, num_frames - 1)]
    frames += [f"{DRIVE} {i} r" for i in range(1, num_frames - 1)]
    n = len(frames)
    groups = {"train": frames[: max(n - 2, 1)],
              "val": frames[max(n - 2, 1):] or frames[:1],
              "test": frames[:2]}
    for name, lines in groups.items():
        with open(os.path.join(splits_dir, f"{name}_files.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return os.path.join(root, "splits")


def _smooth_texture(rng: np.random.Generator, height: int, width: int,
                    cell: int = 8) -> np.ndarray:
    """Multi-octave random RGB texture in ~[0.05, 0.95], f32 [H, W, 3].

    Coarse octaves give photometric gradients at long range, fine octaves
    make alignment locally discriminative."""
    img = np.zeros((height, width, 3), np.float32)
    weight = 1.0
    total = 0.0
    c = max(cell * 16, 16)
    while c >= cell:
        small = rng.uniform(0.0, 1.0, (height // c + 2, width // c + 2, 3))
        img += weight * np.asarray(Image.fromarray(
            (small * 255).astype(np.uint8)).resize((width, height),
                                                   Image.BILINEAR), np.float32) / 255.0
        total += weight
        weight *= 0.55
        c //= 4
    img /= total
    return 0.05 + 0.9 * img


def make_planar_scenes(num_scenes: int, height: int, width: int,
                       seed: int = 0, max_shift_px: float = 14.0,
                       texture_cell: int = 4, tx_sign: float = 0.0):
    """Multi-view scenes of a slanted textured plane.

    Ground-truth inverse depth is linear in pixel coords,
    d(x, y) = a + b·x + c·y, and the source cameras are translated by
    ±tx along x, so the source views are rendered exactly from the
    target's texture by per-row 1-D interpolation.

    Returns a dict shaped for the batch contract (frame order (0, -1, +1);
    jitter disabled) plus ground truth:
      frames   uint8 [N, 3, H, W, 3]
      jitter   f32   [N, 5]
      K/inv_K  f32   [N, 4, 4]
      gt_disp  f32   [N, H, W]
      gt_tx    f32   [N]
    """
    rng = np.random.default_rng(seed)
    K, inv_K = kitti.intrinsics(height, width)
    fx = float(K[0, 0])
    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)

    frames = np.empty((num_scenes, 3, height, width, 3), np.uint8)
    gt_disp = np.empty((num_scenes, height, width), np.float32)
    gt_tx = np.empty((num_scenes,), np.float32)

    for n in range(num_scenes):
        # plane centred on the network's native scaled-disparity units,
        # slopes bounded away from zero so depth has a rank signal
        a = rng.uniform(3.5, 6.5)
        b = rng.choice([-1, 1]) * rng.uniform(0.15, 0.4) * a / width
        c = rng.choice([-1, 1]) * rng.uniform(0.15, 0.4) * a / height
        d = a + b * xs[None, :] + c * ys[:, None]  # [H, W]
        # translation sized so the largest warp shift is ~max_shift_px;
        # tx_sign=0 draws the direction per scene
        sign = float(tx_sign) if tx_sign else float(rng.choice([-1.0, 1.0]))
        tx = sign * max_shift_px / (fx * d.max())

        W_tex = _smooth_texture(rng, height, width, cell=texture_cell)
        # a monocular depth cue: the normalized plane tints the red channel
        d_norm = (d - d.min()) / (d.max() - d.min() + 1e-9)
        W_tex[..., 0] = 0.6 * W_tex[..., 0] + 0.4 * (
            0.1 + 0.8 * d_norm.astype(np.float32))
        frames[n, 0] = np.clip(W_tex * 255.0 + 0.5, 0, 255).astype(np.uint8)
        gt_disp[n] = d.astype(np.float32)
        gt_tx[n] = tx

        # render the ±1 views: source_f = W ∘ A_f⁻¹ with
        # A_f(x, y) = ((1 + s·b)·x + s·c·y + s·a, y), s = fx·tx_f
        for slot, sign in ((1, -1.0), (2, 1.0)):
            s = fx * tx * sign
            inv_x = (xs[None, :] - s * c * ys[:, None] - s * a) / (1.0 + s * b)
            inv_x = np.clip(inv_x, 0.0, width - 1)  # border clamp
            x0 = np.floor(inv_x).astype(np.int64)
            x1 = np.minimum(x0 + 1, width - 1)
            w1 = (inv_x - x0)[..., None]
            rows = np.arange(height)[:, None]
            src = W_tex[rows, x0] * (1.0 - w1) + W_tex[rows, x1] * w1
            frames[n, slot] = np.clip(src * 255.0 + 0.5, 0, 255).astype(np.uint8)

    N = num_scenes
    jitter = np.zeros((N, 5), np.float32)
    jitter[:, 1:4] = 1.0
    return {
        "frames": frames,
        "jitter": jitter,
        "K": np.tile(K, (N, 1, 1)).astype(np.float32),
        "inv_K": np.tile(inv_K, (N, 1, 1)).astype(np.float32),
        "gt_disp": gt_disp,
        "gt_tx": gt_tx,
    }


def spearman_rank(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation of two flat arrays (no tie averaging:
    the values are continuous)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    ra = np.empty_like(a)
    rb = np.empty_like(b)
    ra[np.argsort(a)] = np.arange(a.size)
    rb[np.argsort(b)] = np.arange(b.size)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0
