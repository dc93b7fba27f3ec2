"""KITTI dataset producing fixed-shape numpy samples for the card.

A copy of `monodepth_tpu.data.dataset.KittiDataset` (reference:
kitti_mono.py:258-375, kitti_stereo.py:168-306): the same samples, bit
for bit, from the same per-sample RNG. The host does JPEG decode, one
Lanczos resize to (H, W) per frame, the horizontal flip and the velodyne
-> sparse GT projection; the train and eval steps do uint8 -> float, the
colour jitter and the 4-scale pyramid on the card (`data/augment.py`).

A sample is a dict of numpy arrays with static shapes:
  frames   uint8  [F, H, W, 3]    frame_ids order; flip already applied
  depth_gt f32    [375, 1242]     sparse velodyne GT (flipped with frames)
  K/inv_K  f32    [4, 4]          scale-0 intrinsics (per-axis scaling)
  stereo_T f32    [4, 4]          fixed-baseline extrinsic ("s" frame)
  jitter   f32    [5]             [apply, brightness, contrast, sat, hue]
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, Sequence, Union

import numpy as np
from PIL import Image

from monodepth_tpu_torch import native
from monodepth_tpu_torch.data import kitti

FrameId = Union[int, str]


class KittiDataset:
    """Mono, stereo ("s" with `stereo_T`) and mono+stereo KITTI raw
    dataset. `use_native` picks the C++ decoder (None: where it builds and
    the images are JPEG), else PIL. `gt_cache_dir` keeps the resized
    training GT and `frame_cache_dir` the decoded frames as .npy files,
    keyed by an md5 of the absolute datapath and the frame, published
    atomically (loader threads race on the same sample)."""

    def __init__(self, datapath: str, filenames: Sequence[str],
                 is_training: bool, frame_ids: Sequence[FrameId],
                 height: int = 192, width: int = 640, ext: str = ".jpg",
                 load_depth: bool = True, gt_cache_dir: str | None = None,
                 use_native: bool | None = None,
                 frame_cache_dir: str | None = None):
        if height % 32 or width % 32:
            raise ValueError("(H, W) must be multiples of 32")
        self.datapath = datapath
        self.filenames = list(filenames)
        self.is_training = is_training
        self.frame_ids = tuple(frame_ids)
        self.height = height
        self.width = width
        self.ext = ext
        self.load_depth = load_depth
        self.gt_cache_dir = gt_cache_dir
        if gt_cache_dir:
            os.makedirs(gt_cache_dir, exist_ok=True)
        if use_native is None:
            use_native = ext == ".jpg" and native.available()
        self.use_native = use_native
        # epoch >= 2 skips JPEG decode + Lanczos (~440 KB a frame at 640x192)
        self.frame_cache_dir = frame_cache_dir
        if frame_cache_dir:
            os.makedirs(frame_cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.filenames)

    # -- host-side IO ------------------------------------------------------
    def _load_image(self, folder: str, frame_index: int, side: str,
                    flip: bool) -> np.ndarray:
        path = kitti.image_path(self.datapath, folder, frame_index, side, self.ext)
        if self.frame_cache_dir:
            # the datapath is in the key: a run re-pointed at another tree
            # with the same cache dir must not be served its frames
            key = hashlib.md5(
                f"{os.path.abspath(self.datapath)}|{folder}|{frame_index}|"
                f"{side}|{self.height}x{self.width}".encode()).hexdigest()
            cache = os.path.join(self.frame_cache_dir, key + ".npy")
            if os.path.exists(cache):
                try:
                    arr = np.load(cache)
                    return arr[:, ::-1] if flip else arr
                except (EOFError, ValueError, OSError):
                    pass  # racing writer: recompute
            arr = self._decode(path, flip=False)
            tmp = f"{cache}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
            np.save(tmp, arr)
            os.replace(tmp, cache)
            return arr[:, ::-1] if flip else arr
        return self._decode(path, flip)

    def _decode(self, path: str, flip: bool) -> np.ndarray:
        if self.use_native:
            return native.decode_resize(path, self.height, self.width, flip)
        with open(path, "rb") as f:
            with Image.open(f) as img:
                img = img.convert("RGB")
                if img.size != (self.width, self.height):
                    # reference uses Image.ANTIALIAS (= Lanczos), kitti_mono.py:275
                    img = img.resize((self.width, self.height), Image.LANCZOS)
                arr = np.asarray(img, dtype=np.uint8)
        return arr[:, ::-1] if flip else arr

    def _load_depth(self, folder: str, frame_index: int, side: str) -> np.ndarray:
        cache = None
        if self.gt_cache_dir:
            key = hashlib.md5(  # datapath in the key: see _load_image
                f"{os.path.abspath(self.datapath)}|{folder}|{frame_index}|"
                f"{side}".encode()).hexdigest()
            cache = os.path.join(self.gt_cache_dir, key + ".npy")
            if os.path.exists(cache):
                try:
                    return np.load(cache)
                except (EOFError, ValueError, OSError):
                    pass  # concurrent writer: fall through and recompute
        velo = kitti.velodyne_path(self.datapath, folder, frame_index)
        if not os.path.exists(velo):
            # a few KITTI frames ship without a scan; the training metric
            # masks gt == 0, so an empty map degrades gracefully
            return np.zeros((kitti.GT_HEIGHT, kitti.GT_WIDTH), np.float32)
        depth = kitti.velodyne_to_depth(
            kitti.calib_dir(self.datapath, folder), velo,
            cam=kitti.SIDE_MAP[side])
        depth = kitti.resize_nearest_np(depth, kitti.GT_HEIGHT, kitti.GT_WIDTH)
        if cache:
            # np.save appends ".npy" unless the name already ends with it
            tmp = f"{cache}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
            np.save(tmp, depth)
            os.replace(tmp, cache)
        return depth

    # -- sample assembly ----------------------------------------------------
    def sample(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Sample `index`; `rng` draws flip, jitter, then the four jitter
        parameters, in that order."""
        folder, key_frame, side = kitti.parse_split_line(self.filenames[index])
        do_flip = bool(self.is_training and rng.random() > 0.5)
        do_jitter = bool(self.is_training and rng.random() > 0.5)

        frames = []
        for fid in self.frame_ids:
            if fid == "s":
                img = self._load_image(folder, key_frame,
                                       kitti.OTHER_SIDE[side], do_flip)
            else:
                img = self._load_image(folder, key_frame + fid, side, do_flip)
            frames.append(img)

        out: Dict[str, np.ndarray] = {
            "frames": np.stack(frames).astype(np.uint8),
        }

        if self.load_depth:
            depth = self._load_depth(folder, key_frame, side)
            if do_flip:
                depth = depth[:, ::-1]
            out["depth_gt"] = np.ascontiguousarray(depth, dtype=np.float32)

        K, inv_K = kitti.intrinsics(self.height, self.width)
        out["K"] = K
        out["inv_K"] = inv_K

        if "s" in self.frame_ids:
            out["stereo_T"] = kitti.stereo_transform(side, do_flip)

        # torchvision ColorJitter parameter ranges (kitti_mono.py:284-285)
        out["jitter"] = np.array(
            [1.0 if do_jitter else 0.0,
             rng.uniform(0.8, 1.2), rng.uniform(0.8, 1.2),
             rng.uniform(0.8, 1.2), rng.uniform(-0.1, 0.1)],
            dtype=np.float32)
        return out
