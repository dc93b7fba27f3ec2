"""KITTI raw-format utilities: split lists, calibration, velodyne -> sparse
depth, image paths, intrinsics and the stereo extrinsic (numpy only).

A copy of `monodepth_tpu.data.kitti` (reference: model_utility.py:18-197),
with its documented deviations:

- duplicate-pixel resolution uses an exact vectorized `np.minimum.at`
  (keep the closest return per pixel); the reference's Counter loop keyed
  by a buggy `sub2ind` (rowSub*(n-1)+colSub-1, model_utility.py:119-124)
  could alias distinct pixels.
- `intrinsics()` scales fy by height (the reference's v2 loader scaled
  both rows by width, kitti_mono.py:326-327; the official Monodepth2
  scaling is per-axis).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}
OTHER_SIDE = {"l": "r", "r": "l"}

GT_HEIGHT, GT_WIDTH = 375, 1242

# Normalized pinhole intrinsics used by Monodepth2 for all KITTI drives
# (reference: kitti_mono.py:278-281).
NORMALIZED_K = np.array([[0.58, 0.0, 0.5, 0.0],
                         [0.0, 1.92, 0.5, 0.0],
                         [0.0, 0.0, 1.0, 0.0],
                         [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)

STEREO_BASELINE = 0.1  # normalized-scale baseline (reference: kitti_stereo.py:254)


def readlines(path: str) -> list[str]:
    with open(path, "r") as f:
        return f.read().splitlines()


def savelines(lines, path: str) -> None:
    """Write a split list (reference: model_utility.py:26-31)."""
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def removelines(path: str, predicate) -> list[str]:
    """Drop lines matching `predicate` from a split file in place and
    return the kept lines (reference: model_utility.py:34-55)."""
    kept = [ln for ln in readlines(path) if not predicate(ln)]
    savelines(kept, path)
    return kept


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calibration txt into {key: float array} (string values
    that fail to parse are kept as-is)."""
    data: Dict[str, np.ndarray] = {}
    with open(path, "r") as f:
        for line in f.readlines():
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                data[key] = value  # e.g. calib_time
    return data


def load_velodyne(path: str) -> np.ndarray:
    """KITTI .bin -> [N, 4] homogeneous points (x fwd, y left, z up, 1)."""
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def velodyne_to_depth(calib_dir: str, velo_path: str, cam: int = 2,
                      vel_depth: bool = False) -> np.ndarray:
    """Project a velodyne scan into the rectified camera -> sparse depth map
    at the native rectified image size (reference: model_utility.py:128-197).

    vel_depth=True uses the raw forward distance as depth (the Eigen eval
    convention, model_test.py:55); otherwise the rectified-camera z.
    """
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))

    T_velo2cam = np.eye(4)
    T_velo2cam[:3, :3] = velo2cam["R"].reshape(3, 3)
    T_velo2cam[:3, 3] = velo2cam["T"]

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)  # (H, W)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P = P_rect @ R_rect @ T_velo2cam  # [3, 4] velodyne -> image

    velo = load_velodyne(velo_path)
    velo = velo[velo[:, 0] >= 0]  # points in front of the sensor

    proj = velo @ P.T  # [N, 3]
    z = proj[:, 2].copy()
    uv = proj[:, :2] / z[:, None]
    depth_vals = velo[:, 0] if vel_depth else z

    # -1: match the KITTI matlab indexing convention (model_utility.py:178-179)
    u = np.round(uv[:, 0]) - 1
    v = np.round(uv[:, 1]) - 1
    valid = (u >= 0) & (v >= 0) & (u < im_shape[1]) & (v < im_shape[0])
    u = u[valid].astype(np.int64)
    v = v[valid].astype(np.int64)
    depth_vals = depth_vals[valid]

    # keep the minimum depth where multiple returns land on one pixel
    flat = np.full(im_shape[0] * im_shape[1], np.inf, dtype=np.float64)
    np.minimum.at(flat, v * im_shape[1] + u, depth_vals)
    depth = np.where(np.isfinite(flat), flat, 0.0).reshape(im_shape)
    depth[depth < 0] = 0.0
    return depth.astype(np.float32)


def resize_nearest_np(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Centered nearest-neighbor resize (skimage order-0 equivalent used for
    the 375x1242 training GT, reference: kitti_mono.py:313)."""
    H, W = image.shape[:2]
    rows = np.clip(np.round((np.arange(height) + 0.5) * H / height - 0.5),
                   0, H - 1).astype(np.int64)
    cols = np.clip(np.round((np.arange(width) + 0.5) * W / width - 0.5),
                   0, W - 1).astype(np.int64)
    return image[rows][:, cols]


def image_path(datapath: str, folder: str, frame_index: int, side: str,
               ext: str = ".jpg") -> str:
    return os.path.join(datapath, folder,
                        f"image_0{SIDE_MAP[side]}/data",
                        f"{frame_index:010d}{ext}")


def velodyne_path(datapath: str, folder: str, frame_index: int) -> str:
    return os.path.join(datapath, folder,
                        f"velodyne_points/data/{frame_index:010d}.bin")


def calib_dir(datapath: str, folder: str) -> str:
    return os.path.join(datapath, folder.split("/")[0])


def intrinsics(height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Scale-0 (K, inv_K) for the model resolution, per-axis scaling."""
    K = NORMALIZED_K.copy()
    K[0, :] *= width
    K[1, :] *= height
    return K, np.linalg.inv(K).astype(np.float32)


def stereo_transform(side: str, do_flip: bool) -> np.ndarray:
    """Fixed-baseline extrinsic for the opposite-camera frame
    (reference: kitti_stereo.py:249-256)."""
    T = np.eye(4, dtype=np.float32)
    baseline_sign = -1.0 if do_flip else 1.0
    side_sign = -1.0 if side == "l" else 1.0
    T[0, 3] = side_sign * baseline_sign * STEREO_BASELINE
    return T


def parse_split_line(line: str) -> Tuple[str, int, str]:
    """'2011_09_26/2011_09_26_drive_0022_sync 473 r' -> (folder, 473, 'r')."""
    folder, frame, side = line.split()
    return folder, int(frame), side
