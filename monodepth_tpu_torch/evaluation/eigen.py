"""KITTI Eigen test protocol on the card: the counterpart of
`monodepth_tpu.evaluation.eigen` (reference: model_test.py:61-118).

  1. depth-only forward over the test split at the model's resolution,
     scaled disparity via disparity2depth(min=1e-3, max=80), the eval
     depth range (model_test.py:62-63, 82): `make_infer_step`, batches
     from the `Loader` (native decode, in order, the last batch ragged);
  2. per image: bilinear-resize the disparity to the native GT
     resolution, depth = 1/disp;
  3. Eigen mask (1e-3 < gt < 80) x the Garg crop [153:371, 44:1197] for
     the eigen splits; gt > 0 otherwise (model_test.py:98-105);
  4. per-image median scaling, clamp to [1e-3, 80], 7-metric mean
     (model_test.py:107-115).

GT is projected straight from velodyne with vel_depth=True at the native
rectified size (model_test.py:47-57). Steps 2-4 are host numpy (shapes
vary per drive). The sweep over several processes (`process_slice`,
`evaluate_multihost`) is not ported yet.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Sequence

import numpy as np

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.data.dataset import KittiDataset
from monodepth_tpu_torch.data.pipeline import Loader
from monodepth_tpu_torch.losses.metrics import METRIC_NAMES
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.ops.sampling import _linear_resize_matrix
from monodepth_tpu_torch.training.state import build_model, copy_into, model_modules
from monodepth_tpu_torch.training.step import make_infer_step
from monodepth_tpu_torch.utils.jax_import import module_state_dict
from monodepth_tpu_torch.utils.serialization import load_npz

MIN_DEPTH, MAX_DEPTH = 1e-3, 80.0
GARG_CROP = (153, 371, 44, 1197)  # model_test.py:100


def depth_errors_np(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """The 7 KITTI depth metrics over flat valid pixels (reference:
    model_metric.py:19-44)."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = ((gt - pred) ** 2 / gt).mean()
    return np.array([abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3])


def resize_bilinear_np(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(..., INTER_LINEAR) equivalent: separable half-pixel
    bilinear, no antialiasing, in f64 (model_test.py:95)."""
    Rh = _linear_resize_matrix(image.shape[0], height, False)
    Rw = _linear_resize_matrix(image.shape[1], width, False)
    return Rh @ image.astype(np.float64) @ Rw.T


def load_ground_truth(datapath: str, lines: Sequence[str],
                      cache_dir: str | None = None) -> List[np.ndarray]:
    """Native-size velodyne GT depths, vel_depth=True (model_test.py:47-57).

    `cache_dir` keeps each projected scan as .npy (atomic publish), keyed
    by an md5 of the absolute datapath and the frame, so repeat runs skip
    the projections and a run against another tree is never served this
    one's. These maps are native-size with vel_depth, not the dataset's
    resized training GT."""
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
    out = []
    for line in lines:
        folder, frame, side = kitti.parse_split_line(line)
        cache = None
        if cache_dir:
            key = hashlib.md5(
                f"{os.path.abspath(datapath)}|{folder}|{frame}|{side}|"
                f"native_vel".encode()).hexdigest()
            cache = os.path.join(cache_dir, key + ".npy")
            if os.path.exists(cache):
                try:
                    out.append(np.load(cache))
                    continue
                except (EOFError, ValueError, OSError):
                    pass  # racing writer: recompute
        depth = kitti.velodyne_to_depth(
            kitti.calib_dir(datapath, folder),
            kitti.velodyne_path(datapath, folder, frame),
            cam=kitti.SIDE_MAP[side], vel_depth=True)
        if cache:
            tmp = f"{cache}.{os.getpid()}.tmp.npy"
            np.save(tmp, depth)
            os.replace(tmp, cache)
        out.append(depth)
    return out


def eval_batches(cfg: Config, lines: Sequence[str], eval_batch: int = 16,
                 num_workers: int = 8):
    """The test split's images as [b, H, W, 3] f32 batches in [0, 1], in
    order, the last one ragged: the sweep's input (`Loader` over a
    `KittiDataset` of the key frame, one process)."""
    dataset = KittiDataset(cfg.datapath, lines, is_training=False,
                           frame_ids=(0,), height=cfg.height,
                           width=cfg.width, load_depth=False)
    loader = Loader(dataset, batch_size=eval_batch, shuffle=False,
                    num_workers=num_workers, drop_last=False,
                    process_index=0, process_count=1)
    try:
        for batch in loader.epoch(0):
            yield batch["frames"][:, 0].astype(np.float32) / 255.0
    finally:
        loader.close()


def predict_disparities(cfg: Config, model: Monodepth, lines: Sequence[str],
                        eval_batch: int = 16, num_workers: int = 8,
                        device=None, infer=None) -> np.ndarray:
    """Batched depth-only forward over `lines` -> [N, H, W] scaled
    disparities (f32, host).

    The batches come from `eval_batches`; the last one is ragged and not
    padded (eval mode normalizes with the running statistics, so an
    image's disparity does not depend on its batch-mates). `infer`: a
    `make_infer_step(model, cfg, device)` to reuse; `device` defaults to
    the card."""
    if infer is None:
        infer = make_infer_step(model, cfg, device)
    disps = [infer(images).float().cpu().numpy()
             for images in eval_batches(cfg, lines, eval_batch, num_workers)]
    return np.concatenate(disps)


def eigen_errors(disparities: np.ndarray,
                 ground_truths: Sequence[np.ndarray],
                 datatype: str = "kitti_eigen_zhou") -> np.ndarray:
    """Steps 2-4 of the protocol over precomputed disparities: the
    per-image [N, 7] error matrix (its mean over axis 0 is the table,
    model_test.py:114-115)."""
    errors = []
    eigen = "eigen" in datatype
    for disp, gt in zip(disparities, ground_truths):
        height, width = gt.shape
        pred_depth = 1.0 / resize_bilinear_np(disp, height, width)

        if eigen:
            mask = np.logical_and(gt > MIN_DEPTH, gt < MAX_DEPTH)
            crop_mask = np.zeros_like(mask)
            crop_mask[GARG_CROP[0]:GARG_CROP[1],
                      GARG_CROP[2]:GARG_CROP[3]] = True
            mask = np.logical_and(mask, crop_mask)
        else:
            mask = gt > 0.0

        pred = pred_depth[mask]
        gt_m = gt[mask]
        pred *= np.median(gt_m) / np.median(pred)
        pred = np.clip(pred, MIN_DEPTH, MAX_DEPTH)
        errors.append(depth_errors_np(gt_m, pred))
    if not errors:
        return np.zeros((0, len(METRIC_NAMES)))
    return np.stack(errors)


def eigen_metrics(disparities: np.ndarray,
                  ground_truths: Sequence[np.ndarray],
                  datatype: str = "kitti_eigen_zhou") -> Dict[str, float]:
    """The 7-metric mean-over-images table (reference model_test.py), as
    plain floats. Raises on an empty sweep rather than return NaNs."""
    errors = eigen_errors(disparities, ground_truths, datatype)
    if not len(errors):
        raise ValueError("eigen_metrics: empty sweep (no images)")
    return dict(zip(METRIC_NAMES, errors.mean(0).tolist()))


def evaluate(cfg: Config, model: Monodepth,
             lines: Sequence[str] | None = None,
             ground_truths: Sequence[np.ndarray] | None = None,
             eval_batch: int = 16, device=None) -> Dict[str, float]:
    """Full protocol: forward + metrics. Returns {metric: value}."""
    if lines is None:
        lines = kitti.readlines(os.path.join(
            cfg.splits, cfg.datatype, "test_files.txt"))
    if ground_truths is None:
        ground_truths = load_ground_truth(cfg.datapath, lines)
    disps = predict_disparities(cfg, model, lines, eval_batch, device=device)
    return eigen_metrics(disps, ground_truths, cfg.datatype)


def parse_weights_spec(spec: str) -> tuple[str, int]:
    """`<dir>:<epoch>` -> (dir, epoch). The LAST colon splits, so a
    directory path containing colons still parses."""
    directory, sep, epoch = spec.rpartition(":")
    if not sep or not epoch.isdigit():
        raise ValueError(f"weights spec {spec!r} must be <dir>:<epoch>")
    return directory, int(epoch)


def detect_scales(weights_dir: str, epoch: int) -> tuple[int, ...] | None:
    """Infer the training scales from a decoder npz export (its
    `dispconv_<s>` heads). Returns None if no decoder file exists."""
    path = os.path.join(weights_dir, f"decoder{epoch}.npz")
    if not os.path.exists(path):
        return None
    tree = load_npz(path)["params"]
    return tuple(sorted(int(k.rsplit("_", 1)[1]) for k in tree
                        if k.startswith("dispconv_")))


def state_from_modules(cfg: Config, weights_dir: str, epoch: int,
                       device=None) -> Monodepth:
    """The model of `cfg` (seeded init, eval mode, on `device`, default
    the card) with the per-module npz exports `<module><epoch>.npz` of
    `weights_dir` loaded (the JAX package's export layout, which its
    Checkpointer and both packages' `convert_torch_weights` write;
    reference layout: model_tool/logger.py:60-66, model_test.py:29-43).

    The encoder and decoder must be there. A missing pose module is left
    at init with a message: the depth-only eval does not run it. An
    export without batch_stats leaves that module's BN buffers at init."""
    model = build_model(cfg, device)
    loaded = {}
    for name in model_modules(model):
        path = os.path.join(weights_dir, f"{name}{epoch}.npz")
        if not os.path.exists(path):
            if name in ("encoder", "decoder"):
                raise FileNotFoundError(path)
            print(f">>> {name}{epoch}.npz not found; leaving {name} at "
                  f"init (depth-only eval does not run it)")
            continue
        tree = load_npz(path)
        loaded.update(module_state_dict(name, tree["params"],
                                        tree.get("batch_stats"),
                                        cfg.num_layers, cfg.scales))
    copy_into(model, loaded)
    return model


def print_table(name: str, metrics: Dict[str, float]) -> None:
    """The reference's console table (model_test.py:117-118)."""
    print(f">>> {name}")
    print(">>>   abs_rel   sqrt_rel  rmse      rmse_log  a1        a2        a3")
    print(">>>" + ("   {:4.3f}  " * 7).format(
        *[metrics[k] for k in METRIC_NAMES]))
