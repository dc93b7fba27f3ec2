"""Hermetic convergence proof on the card: train on exact synthetic
geometry, check that the loss drops and that the predicted depth
rank-correlates with the ground truth.

    python -m monodepth_tpu_torch.tools.convergence_proof --mode stereo \
        --steps 600 --use_pallas true

Counterpart of the JAX package's `tools/convergence_proof.py`:
`make_planar_scenes` renders scenes whose photometric minimum sits at the
ground-truth inverse-depth plane, so no KITTI data is needed. Two modes,
as there:
- stereo (the default): frames (0, "s"), the +tx view fed as the "s"
  frame with its ground-truth fixed-baseline transform as `stereo_T`
  (identity with the scene's `gt_tx` at [0, 3]): the pose is known and
  depth must emerge through the warp; 2 warps per scale;
- mono: frames (0, -1, 1) with the pose net in the loop; 8 warps a step.
Depth is identifiable only up to a global scale, so the depth check is
Spearman's rank correlation per scene. The learning rate is constant over
the run (`steps_per_epoch=steps`: the StepLR decay, made for KITTI's
26k-image epochs, never fires). With `--use_pallas true` on the card the
warps run the CUDA kernels (K1, K1-bwd). The JAX tool's diagnostic flags
`--frames` and `--augment` are left out. `--device` (default: the card;
`cpu` runs the plain PyTorch path) is added. The exit code is 0 when the
run passes the tool's rule (in `main`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _bool(text: str) -> bool:
    return text.lower() in ("1", "true", "yes")


def main(argv=None) -> dict:
    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.data.synthetic import make_planar_scenes, spearman_rank
    from monodepth_tpu_torch.training.state import build_model, create_state, resolve_device
    from monodepth_tpu_torch.training.step import make_infer_step, make_train_step

    p = argparse.ArgumentParser(description="hermetic convergence proof")
    p.add_argument("--mode", default="stereo", choices=["stereo", "mono"],
                   help="stereo: frames (0, 's') with the ground-truth baseline "
                        "transform as stereo_T: the pose is known, depth must "
                        "emerge through the warp. mono: frames (0, -1, 1) with "
                        "the pose net in the loop")
    p.add_argument("--steps", default=600, type=int)
    p.add_argument("--height", default=96, type=int)
    p.add_argument("--width", default=320, type=int)
    p.add_argument("--batch", default=8, type=int)
    p.add_argument("--scenes", default=32, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--use_automasking", default=True, type=_bool)
    p.add_argument("--tx_sign", default=0.0, type=float,
                   help="every scene's translation direction (+1/-1); 0 draws "
                        "it per scene")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--precision", default="", choices=["", "bf16", "f32"],
                   help="default bf16 on the card, f32 on the CPU")
    p.add_argument("--use_pallas", default=False, type=_bool,
                   help="the CUDA warp kernels (their plain versions on the CPU)")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    p.add_argument("--out", default="", type=str, help="write a markdown report here")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    frame_ids = (0, "s") if args.mode == "stereo" else (0, -1, 1)
    precision = args.precision or ("bf16" if device.type == "cuda" else "f32")
    cfg = Config(height=args.height, width=args.width, batch=args.batch,
                 learning_rate=args.learning_rate, seed=args.seed,
                 weight_init=False, use_pallas=args.use_pallas,
                 frame_ids=frame_ids, use_automasking=args.use_automasking,
                 precision=precision, train_gt_metrics=False).validate()
    print(f">>> device {device}, {args.scenes} scenes at {args.height}x{args.width}, "
          f"batch {args.batch}, {args.steps} steps, {precision}, "
          f"use_pallas {args.use_pallas}")

    scenes = make_planar_scenes(args.scenes, args.height, args.width,
                                seed=args.seed, tx_sign=args.tx_sign)
    batch_keys = ("frames", "jitter", "K", "inv_K")
    if args.mode == "stereo":
        # slot 2 is the +tx view: the "s" frame, with its ground-truth
        # fixed-baseline transform (the step warps "s" by stereo_T as given)
        scenes["frames"] = scenes["frames"][:, [0, 2]]
        stereo_T = np.tile(np.eye(4, dtype=np.float32), (args.scenes, 1, 1))
        stereo_T[:, 0, 3] = scenes["gt_tx"]
        scenes["stereo_T"] = stereo_T
        batch_keys += ("stereo_T",)
    model = build_model(cfg, device)
    # a constant learning rate: steps_per_epoch=steps keeps the StepLR decay
    # from firing
    state = create_state(cfg, model, steps_per_epoch=args.steps)
    train_step = make_train_step(model, cfg, device)
    infer = make_infer_step(model, cfg, device)

    def batch_at(order, start):
        idx = order[start:start + args.batch]
        return {k: scenes[k][idx] for k in batch_keys}

    def depth_corrs():
        """Per-scene Spearman(predicted disparity, GT disparity), interior."""
        corrs = []
        for start in range(0, args.scenes, args.batch):
            images = scenes["frames"][start:start + args.batch, 0]
            disp = infer(images.astype(np.float32) / 255.0).float().cpu().numpy()
            for i in range(disp.shape[0]):
                interior = np.s_[4:-4, 8:-8]
                corrs.append(spearman_rank(disp[i][interior],
                                           scenes["gt_disp"][start + i][interior]))
        return np.asarray(corrs)

    corr0 = depth_corrs()
    rng = np.random.default_rng(args.seed)
    losses = []  # on the device: fetched at the log lines and the end
    t0 = time.perf_counter()
    step = 0
    while step < args.steps:
        order = rng.permutation(args.scenes)
        for start in range(0, args.scenes - args.batch + 1, args.batch):
            if step >= args.steps:
                break
            losses.append(train_step(state, batch_at(order, start))["loss"])
            step += 1
            if step % 50 == 0 or step == 1:
                print(f"    step {step:4d} loss {float(losses[-1]):.4f}")
    losses = torch.stack(losses).float().cpu().numpy()
    train_time = time.perf_counter() - t0

    corr1 = depth_corrs()
    bad = [(i, round(float(c), 2), round(float(scenes["gt_tx"][i]), 4))
           for i, c in enumerate(corr1) if c < 0.5]
    if bad:
        print(f"    scenes with corr < 0.5 (idx, corr, gt_tx): {bad}")
    disp = infer(scenes["frames"][:args.batch, 0].astype(np.float32) / 255.0)
    disp = disp.float().cpu().numpy()
    print(f"    pred scaled-disp mean {disp.mean():.3f} per-image std "
          f"{disp.std(axis=(1, 2)).mean():.4f} (gt plane std "
          f"{scenes['gt_disp'][:args.batch].std(axis=(1, 2)).mean():.4f})")
    loss0 = float(np.mean(losses[:10]))
    loss1 = float(np.mean(losses[-10:]))
    # pass: the loss halves, and the trained depth's mean rank correlation
    # exceeds 0.75, beats the untrained net's by more than 0.25 (the tint
    # cue gives a random net ~0.4) and no scene is inverted
    ok = (loss1 < 0.5 * loss0 and float(corr1.mean()) > 0.75
          and float(corr1.mean() - corr0.mean()) > 0.25 and float(corr1.min()) > 0.0)
    result = {
        "mode": args.mode,
        "steps": args.steps,
        "resolution": f"{args.height}x{args.width}",
        "batch": args.batch,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "precision": precision,
        "use_pallas": args.use_pallas,
        "frame_ids": list(map(str, frame_ids)),
        "tx_sign": args.tx_sign,
        "loss_first10": round(loss0, 4),
        "loss_last10": round(loss1, 4),
        "loss_ratio": round(loss1 / loss0, 4),
        "rank_corr_untrained_mean": round(float(corr0.mean()), 4),
        "rank_corr_trained_mean": round(float(corr1.mean()), 4),
        "rank_corr_trained_min": round(float(corr1.min()), 4),
        "train_seconds": round(train_time, 1),
        "pass": bool(ok),
        "per_scene_corr": [round(float(c), 3) for c in corr1],
    }
    print(json.dumps(result))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("# Hermetic convergence proof\n\n"
                    f"Command: `python -m monodepth_tpu_torch.tools.convergence_proof "
                    f"--mode {args.mode} --steps {args.steps} --height {args.height} "
                    f"--width {args.width} --batch {args.batch} --scenes {args.scenes} "
                    f"--tx_sign {args.tx_sign} --use_pallas {args.use_pallas}`\n\n"
                    "| quantity | value |\n|---|---|\n"
                    + "".join(f"| {k} | {v} |\n" for k, v in result.items()
                              if k != "per_scene_corr")
                    + "\nPer-scene Spearman: "
                    + " ".join(str(c) for c in result["per_scene_corr"]) + "\n")
        print(f">>> wrote {args.out}")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
