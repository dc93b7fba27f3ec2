"""Trajectory (odometry) evaluation: ATE over 5-frame snippets.

    python -m monodepth_tpu_torch.tools.evaluate_poses predicted_poses.npy gt_poses.npy

Counterpart of the JAX package's `tools/evaluate_poses.py` (numpy,
copied). Compares two [N, 4, 4] camera-to-world pose arrays (say,
`monodepth_tpu_torch.tools.export_poses` output against ground truth) by
the KITTI odometry protocol of the Monodepth2 lineage: for every 5-frame
window, scale-align the predicted relative trajectory to the ground truth
(monocular scale ambiguity) and report the mean absolute trajectory error
of the translations. The reference ships a predicted-poses artifact in
this format (model_save/official_monostereo/poses.npy) but no evaluator.
"""

from __future__ import annotations

import argparse

import numpy as np


def snippet_ate(pred: np.ndarray, gt: np.ndarray, length: int = 5):
    """Mean / std ATE over sliding `length`-frame snippets.

    pred, gt: [N, 4, 4] global camera-to-world poses.
    """
    if len(pred) != len(gt):
        raise ValueError(f"pose count mismatch: {len(pred)} vs {len(gt)}")
    if len(pred) < length:
        raise ValueError(f"need at least {length} poses")

    errors = []
    for start in range(len(pred) - length + 1):
        # relative translations within the snippet, anchored at its head
        p = np.linalg.inv(pred[start]) @ pred[start:start + length]
        g = np.linalg.inv(gt[start]) @ gt[start:start + length]
        pt = p[:, :3, 3]
        gt_t = g[:, :3, 3]
        # optimal scale alignment (monocular ambiguity)
        denom = float((pt * pt).sum())
        scale = float((gt_t * pt).sum()) / denom if denom > 0 else 1.0
        errors.append(np.sqrt(((scale * pt - gt_t) ** 2).sum(-1)).mean())
    errors = np.asarray(errors)
    return float(errors.mean()), float(errors.std())


def main():
    p = argparse.ArgumentParser(description="snippet ATE pose evaluation")
    p.add_argument("pred", help="[N,4,4] predicted poses .npy")
    p.add_argument("gt", help="[N,4,4] ground-truth poses .npy")
    p.add_argument("--length", default=5, type=int)
    args = p.parse_args()

    mean, std = snippet_ate(np.load(args.pred), np.load(args.gt),
                            args.length)
    print(f">>> Trajectory error: {mean:.4f}, std: {std:.4f}")


if __name__ == "__main__":
    main()
