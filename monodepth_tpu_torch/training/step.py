"""The train, eval and infer steps: decode -> forward -> warp -> loss ->
metrics (-> backward -> Adam).

Counterpart of `monodepth_tpu.training.step` for one device. Semantics as
there (reference: model_tool/processor.py:33-218):
- depth and pose nets consume `color_aug`; warping samples the
  unaugmented full-res sources, and the loss target is unaugmented
  scale-0 color;
- disparity at every scale is upsampled bilinearly (align_corners=False)
  to full resolution before depth conversion and warping, with scale-0
  intrinsics;
- the 4x4 transforms of the `separate` wiring do not depend on depth, so
  there is one per source frame, outside the scale loop.

Under --precision bf16 only the network runs under `torch.autocast`;
disparities and poses leave it in f32 and the geometry, warps and loss
stay f32 (or wider, following the inputs). The 8 warps of a step
(2 sources x 4 scales) go through the CUDA kernels when `cfg.use_pallas`
is on: `warp_sample` in the eval step, `WarpSample` (forward with the tap
differences, gradient with respect to the grid) in the train step.
Otherwise they are the plain `grid_sample`, differentiated by autograd.
Each step sets the model's mode itself: `.train()` for the train step
(batch statistics, running statistics updated), `.eval()` for the others.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch
from torch.profiler import record_function

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.augment import decode_frames
from monodepth_tpu_torch.losses.metrics import training_depth_metric
from monodepth_tpu_torch.losses.reprojection import monodepth_loss
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.ops.cuda.warp_sample import WarpSample, dy_span, warp_sample
from monodepth_tpu_torch.ops.geometry import (
    disparity_to_depth,
    transform_from_parameters,
    warp_grid,
)
from monodepth_tpu_torch.ops.sampling import grid_sample, pyramid, resize_bilinear
from monodepth_tpu_torch.training.state import TrainState, resolve_device

Tensor = torch.Tensor
Sampler = Callable[[Tensor, Tensor], Tensor]


def _autocast(cfg: Config, device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.precision == "bf16")


def _to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def apply_and_warp(model: Monodepth, batch: Dict[str, Tensor], cfg: Config,
                   *, train: bool = False,
                   sampler: Sampler | None = None) -> Dict[str, Any]:
    """Forward the model and synthesize every (scale, source) warp.

    batch: frames uint8 [B, F, H, W, 3], jitter [B, 5], K and inv_K
    [B, 4, 4], on the model's device. `train` only picks the default warp;
    the caller sets the model's mode and the autograd context. `sampler`
    overrides the warp (default under `cfg.use_pallas`: `WarpSample.apply`
    with `train`, `warp_sample` without; else `grid_sample`). The sources
    carry no gradient. Returns disps / warped / sources / target_pyr /
    depth0 / warp_span, all f32 (or the inputs' wider type) whatever the
    network's precision."""
    device = batch["frames"].device
    color, color_aug = decode_frames(batch["frames"], batch["jitter"])
    with _autocast(cfg, device):
        disps, poses = model(color_aug)

    f32 = torch.promote_types(torch.float32, color.dtype)
    H, W = cfg.height, cfg.width
    source_ids = list(cfg.source_frame_ids)
    target = color[:, 0].to(f32)
    # contiguous once here: each source feeds one warp per scale
    sources = [color[:, cfg.frame_ids.index(fid)].to(f32).contiguous()
               for fid in source_ids]
    K = batch["K"].to(f32)
    inv_K = batch["inv_K"].to(f32)
    disps = {s: d.to(f32) for s, d in disps.items()}
    transforms = {fid: transform_from_parameters(
        poses[fid][0].to(f32), poses[fid][1].to(f32),
        invert=model.invert_for_frame(fid)) for fid in source_ids}

    if sampler is None:
        if not cfg.use_pallas:
            sampler = grid_sample
        else:
            sampler = WarpSample.apply if train else warp_sample
    telemetry = cfg.use_pallas or cfg.warp_telemetry

    warped: Dict[int, list] = {}
    depth0 = None
    warp_span = None
    for scale in cfg.scales:
        disp_full = resize_bilinear(disps[scale], H, W, align_corners=False)
        _, depth = disparity_to_depth(disp_full, cfg.min_depth, cfg.max_depth)
        if scale == 0:
            depth0 = depth
        warps = []
        for fid, src in zip(source_ids, sources):
            grid = warp_grid(depth, inv_K, K, transforms[fid])
            if telemetry and scale == 0:
                span = dy_span(grid.detach())
                warp_span = span if warp_span is None \
                    else torch.maximum(warp_span, span)
            warps.append(sampler(src, grid))
        warped[scale] = warps

    return {
        "disps": disps,
        "warped": warped,
        "sources": sources,
        "target_pyr": pyramid(target, max(cfg.scales) + 1),
        "depth0": depth0,
        "warp_span": warp_span,
    }


def tie_noise_generator(seed: int, step: int, index: int | None,
                        device: torch.device) -> torch.Generator:
    """The generator of the automask tie-break noise: keyed by (seed, step)
    for a train step, and by (seed, step, index) for an eval batch, so
    every batch of a pass draws afresh."""
    entropy = [seed, step] if index is None else [seed, step, index]
    key = np.random.SeedSequence(entropy).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(key))


def _loss(out: Dict[str, Any], noise, cfg: Config) -> Tensor:
    loss, _ = monodepth_loss(
        out["disps"], out["warped"], out["sources"], out["target_pyr"],
        noise, scales=cfg.scales, disp_smoothness=cfg.disp_smoothness,
        use_automasking=cfg.use_automasking)
    return loss


@torch.no_grad()
def _metrics(loss: Tensor, out: Dict[str, Any], batch: Dict[str, Tensor],
             with_gt: bool = True):
    """loss, warp_span (when computed) and, with `with_gt` and `depth_gt`
    in the batch, the 7 depth metrics; all detached."""
    metrics = {"loss": loss.detach()}
    if out["warp_span"] is not None:
        metrics["warp_span"] = out["warp_span"]
    if with_gt and "depth_gt" in batch:
        metrics.update(training_depth_metric(out["depth0"].detach(),
                                             batch["depth_gt"]))
    return metrics


def make_train_step(model: Monodepth, cfg: Config, device=None,
                    sampler: Sampler | None = None):
    """Training step: forward, warps, loss, backward and one Adam update
    (reference: model_train.py:64-71; JAX: `_train_step_body`).

    Returns train_step(state, batch, noise=None) -> {name: 0-d tensor}:
    loss, warp_span (when the kernels are on) and, with
    --train_gt_metrics and `depth_gt` in the batch, the 7 depth metrics.
    It updates `state` in place: the model's parameters and batch-norm
    running statistics, the optimizer, and `state.step`. `state` needs an
    optimizer (`create_state(cfg, model, steps_per_epoch=...)`). The
    tie-break noise comes from `tie_noise_generator(state.seed,
    state.step, None)` unless `noise` ({scale: [B, H, W, n_sources]
    tensor}) is given. `device` defaults to the card. The forward,
    backward and optimizer phases are `torch.profiler` ranges
    ("train_step/forward", "train_step/backward", "train_step/optimizer")."""
    device = resolve_device(device)

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   noise: Mapping[int, Tensor] | None = None):
        if state.optimizer is None:
            raise ValueError("the train step needs an optimizer: build the "
                             "state with create_state(cfg, model, "
                             "steps_per_epoch=...)")
        model.train()
        batch = _to_device(batch, device)
        with record_function("train_step/forward"):
            out = apply_and_warp(model, batch, cfg, train=True, sampler=sampler)
            if noise is None:
                noise = tie_noise_generator(state.seed, state.step, None, device)
            loss = _loss(out, noise, cfg)
        with record_function("train_step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("train_step/optimizer"):
            state.apply_gradients()
        return _metrics(loss, out, batch, with_gt=cfg.train_gt_metrics)

    return train_step


def make_eval_step(model: Monodepth, cfg: Config, device=None,
                   sampler: Sampler | None = None):
    """Validation step: full forward + loss + metrics, no gradient
    (reference: model_train.py:75-79).

    Returns eval_step(state, batch, index=0, noise=None) -> {name: 0-d
    tensor}: loss, warp_span (when the kernels are on) and, when the
    batch has `depth_gt`, the 7 depth metrics. `index` is the batch number
    within the pass; the tie-break noise comes from
    `tie_noise_generator(state.seed, state.step, index)` unless `noise`
    ({scale: [B, H, W, n_sources] tensor}) is given. `device` defaults to
    the card."""
    device = resolve_device(device)

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping[str, Any], index: int = 0,
                  noise: Mapping[int, Tensor] | None = None):
        model.eval()
        batch = _to_device(batch, device)
        out = apply_and_warp(model, batch, cfg, train=False, sampler=sampler)
        if noise is None:
            noise = tie_noise_generator(state.seed, state.step, index, device)
        return _metrics(_loss(out, noise, cfg), out, batch)

    return eval_step


def make_infer_step(model: Monodepth, cfg: Config, device=None):
    """Depth-only batched inference: infer(images [B, H, W, 3] in [0, 1])
    -> scaled disparity [B, H, W], converted with the eval depth range
    1e-3 to 80 whatever the training range (reference: model_test.py:80-83).
    `device` defaults to the card."""
    device = resolve_device(device)

    @torch.inference_mode()
    def infer(images) -> Tensor:
        model.eval()
        images = torch.as_tensor(images).to(device, torch.float32)
        with _autocast(cfg, device):
            disps = model.depth(images)
        scaled_disp, _ = disparity_to_depth(disps[0].float(), 1e-3, 80.0)
        return scaled_disp[..., 0]

    return infer
