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
- the 4x4 transforms of the `separate` and `shared` wirings do not
  depend on depth, so there is one per temporal source, outside the scale
  loop; `posecnn` scales each translation by the mean inverse depth of
  the scale's upsampled depth, so its transforms are built per scale
  (and differentiated through that depth); the stereo frame "s" warps
  with the batch's `stereo_T`.

Under --precision bf16 only the network runs under `torch.autocast`;
disparities and poses leave it in f32 and the geometry, warps and loss
stay f32 (or wider, following the inputs). The warps of a step (one per
source frame and scale: 8 for frames (0, -1, 1) and 4 scales, 12 with
"s") go through the CUDA kernels when `cfg.use_pallas` is on: `warp_sample` in the eval step, `WarpSample` (forward with the tap
differences, gradient with respect to the grid) in the train step.
Otherwise they are the plain `grid_sample`, differentiated by autograd.
Under --remat each warp (whichever sampler) is checkpointed as in JAX:
its backward recomputes the forward, so `WarpSample` launches K1 twice.
Each step sets the model's mode itself: `.train()` for the train step
(batch statistics, running statistics updated), `.eval()` for the others.

Under a process mesh (`parallel.make_mesh`, `mesh=`), each rank holds its
piece of the global batch (`parallel.shard_batch`) and the train and eval
steps compute what the single-device step computes on the global batch:
- data axis: batch norm normalizes with the global batch's statistics
  (`models.resnet.sync_batch_stats`), the gradients are averaged over
  the ranks, the tie-break noise is drawn for the global batch and sliced
  to this rank's items, the loss is the mean over ranks and the depth
  metrics are computed on the gathered depths;
- spatial axis: the network stays replicated over the spatial group (it
  gathers its frames by rows first); each rank warps its own rows of the
  sources with its rows of the grids on a halo-extended slab
  (`_spatial_sampler`, kernel K3), and the warped rows are gathered
  back, so the loss is replicated and every rank ends with the same
  gradient. Splitting the network itself by rows is later work.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.augment import decode_frames
from monodepth_tpu_torch.losses.metrics import training_depth_metric
from monodepth_tpu_torch.losses.reprojection import monodepth_loss
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.models.resnet import sync_batch_stats
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    WarpSample,
    WarpSampleShifted,
    dy_span,
    warp_sample,
    warp_sample_shifted,
)
from monodepth_tpu_torch.ops.geometry import (
    disparity_to_depth,
    transform_from_parameters,
    warp_grid,
)
from monodepth_tpu_torch.ops.sampling import grid_sample, pyramid, resize_bilinear
from monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    average_gradients,
    exchange_halo,
    gather_rows,
    split_rows,
)
from monodepth_tpu_torch.training.state import TrainState, resolve_device

Tensor = torch.Tensor
Sampler = Callable[[Tensor, Tensor], Tensor]


def _autocast(cfg: Config, device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.precision == "bf16")


def _to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def apply_and_warp(model: Monodepth, batch: Dict[str, Tensor], cfg: Config,
                   *, train: bool = False, sampler: Sampler | None = None,
                   own_frames: Tensor | None = None) -> Dict[str, Any]:
    """Forward the model and synthesize every (scale, source) warp.

    batch: frames uint8 [B, F, H, W, 3], jitter [B, 5], K and inv_K
    [B, 4, 4] and, with the stereo frame, stereo_T [B, 4, 4], on the
    model's device. `train` only picks the default warp;
    the caller sets the model's mode and the autograd context. `sampler`
    overrides the warp (default under `cfg.use_pallas`: `WarpSample.apply`
    with `train`, `warp_sample` without; else `grid_sample`). The sources
    carry no gradient. With `own_frames` (this rank's rows of the frames,
    under a spatial mesh) the sampler warps the sources decoded from them
    instead of the full-height ones. Returns disps / warped / sources /
    target_pyr / depth0 / warp_span, all f32 (or the inputs' wider type)
    whatever the network's precision."""
    device = batch["frames"].device
    color, color_aug = decode_frames(batch["frames"], batch["jitter"])
    with _autocast(cfg, device):
        disps, poses = model(color_aug)

    f32 = torch.promote_types(torch.float32, color.dtype)
    H, W = cfg.height, cfg.width
    source_ids = list(cfg.source_frame_ids)
    target = color[:, 0].to(f32)

    def source_images(frames):  # contiguous once: each feeds a warp per scale
        return [frames[:, cfg.frame_ids.index(fid)].to(f32).contiguous()
                for fid in source_ids]

    sources = source_images(color)
    # decoded as decode_frames decodes `color`
    warp_sources = sources if own_frames is None \
        else source_images(own_frames.to(color.dtype) / 255.0)
    K = batch["K"].to(f32)
    inv_K = batch["inv_K"].to(f32)
    disps = {s: d.to(f32) for s, d in disps.items()}
    poses = {fid: (aa.to(f32), t.to(f32)) for fid, (aa, t) in poses.items()}
    # depth-independent for shared/separate: one per source, hoisted
    transforms = {}
    if cfg.pose_type in ("shared", "separate"):
        transforms = {fid: transform_from_parameters(
            *poses[fid], invert=model.invert_for_frame(fid))
            for fid in source_ids if fid != "s"}

    if sampler is None:
        if not cfg.use_pallas:
            sampler = grid_sample
        else:
            sampler = WarpSample.apply if train else warp_sample
    if cfg.remat and torch.is_grad_enabled():
        sampler = functools.partial(checkpoint, sampler, use_reentrant=False)
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
        for fid, src in zip(source_ids, warp_sources):
            if fid == "s":
                T = batch["stereo_T"].to(f32)
            elif cfg.pose_type == "posecnn":
                aa, t = poses[fid]
                mean_inv_depth = (1.0 / depth).mean(dim=(1, 2, 3))
                T = transform_from_parameters(
                    aa, t * mean_inv_depth[:, None],
                    invert=model.invert_for_frame(fid))
            else:
                T = transforms[fid]
            grid = warp_grid(depth, inv_K, K, T)
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


def slab_holds_taps(grid_rows: Tensor, row0: int, slab_rows: int,
                    full_height: int) -> Tensor:
    """Whether every tap row (anchor and anchor + 1) of `grid_rows` lies in
    the slab of `slab_rows` rows whose first row is the global row `row0`
    -> 0-d bool tensor. The anchor is the warp's, clamped to
    [0, full_height - 2], so the edge shards never fail at the image's
    border. A NaN coordinate counts as outside."""
    H = full_height
    y = torch.clamp((grid_rows[..., 1] + 1.0) * 0.5 * (H - 1), 0.0, H - 1)
    rel = torch.clamp(torch.floor(y), 0, H - 2) - row0
    return ((rel >= 0) & (rel + 1 <= slab_rows - 1)).all()


def local_warp(own_rows: Tensor, from_prev: Tensor, from_next: Tensor,
               grid_rows: Tensor, s: int, full_height: int,
               train: bool) -> Tensor:
    """One rank's warp under a spatial mesh, with no collective: the slab
    [from_prev; own_rows; from_next] (halo rows from the neighbours, zeros
    at the image's edges) starts at global row s·Hl - halo, and K3 warps
    it by `grid_rows` (this rank's output rows, global coordinates):
    `WarpSampleShifted` (gradient to the grid) with `train`,
    `warp_sample_shifted` without. Exact when `slab_holds_taps` holds.
    `local_warp.calls` counts it (on a CPU tensor K3 runs its plain
    version and counts no launch)."""
    local_warp.calls += 1
    halo = from_prev.shape[1]
    row0 = s * own_rows.shape[1] - halo
    slab = torch.cat([from_prev, own_rows, from_next], 1)
    if train:
        return WarpSampleShifted.apply(slab, grid_rows, row0, full_height)
    return warp_sample_shifted(slab, grid_rows, row0, full_height)


local_warp.calls = 0


def spatial_fallback(own_rows: Tensor, grid_rows: Tensor, mesh: Mesh) -> Tensor:
    """The exact warp of this rank's rows when a tap leaves the slab: the
    spatial group's rows gathered, then the plain `grid_sample` (autograd
    to the grid), as JAX's fallback. `spatial_fallback.calls` counts it."""
    spatial_fallback.calls += 1
    return grid_sample(all_gather_cat(own_rows, mesh.spatial_group, 1), grid_rows)


spatial_fallback.calls = 0


def _spatial_sampler(cfg: Config, mesh: Mesh):
    """The warp under a spatial mesh (counterpart of JAX's
    `_spatial_pallas_sampler`) -> sample(own_rows, grid_rows, train).

    Each rank owns Hl = H / n rows. A warp's taps stay within a few rows
    of its output row in trained regimes, so the rank sends
    halo = min(cfg.spatial_halo, Hl) edge rows to each neighbour (one
    `batch_isend_irecv`), checks that every tap lies in its slab, agrees
    on that with the group (all_reduce MIN) and runs `local_warp` (K3).
    If any rank of the group has a tap outside, all take
    `spatial_fallback`. The branch is a host decision: the agreed flag is
    read with `.item()`, one device sync per warp. Sources carry no
    gradient (the warp's contract), so the exchange has no backward."""
    n, H = mesh.spatial, cfg.height
    if H % n or H // n < 2:
        raise ValueError(f"height {H} does not split into rows of >= 2 over "
                         f"spatial={n}")
    Hl = H // n
    halo = min(cfg.spatial_halo, Hl)
    s = mesh.spatial_index

    def sample(own_rows: Tensor, grid_rows: Tensor, train: bool) -> Tensor:
        own_rows = own_rows.detach()
        from_prev, from_next = exchange_halo(own_rows, halo, mesh)
        ok = slab_holds_taps(grid_rows.detach(), s * Hl - halo, Hl + 2 * halo,
                             H).to(torch.int32).reshape(1)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.spatial_group)
        if ok.item():
            return local_warp(own_rows, from_prev, from_next, grid_rows, s, H,
                              train)
        return spatial_fallback(own_rows, grid_rows, mesh)

    return sample


def _spatial_warp(cfg: Config, mesh: Mesh | None, sampler: Sampler | None,
                  train: bool) -> Sampler | None:
    """The sampler of a spatial mesh's steps -> sample(own source rows,
    full-height grid): this rank's grid rows (`split_rows`), its warp
    (`_spatial_sampler`), the rows gathered back (`gather_rows`). None
    where the warps run on full-height sources: no spatial axis, the
    kernels off, or a `sampler` given."""
    if mesh is None or mesh.spatial == 1 or not cfg.use_pallas or sampler is not None:
        return None
    spatial = _spatial_sampler(cfg, mesh)

    def sample(own_rows: Tensor, grid: Tensor) -> Tensor:
        return gather_rows(spatial(own_rows, split_rows(grid, mesh), train), mesh)

    return sample


def _gather_frames(batch: Dict[str, Tensor], mesh: Mesh | None):
    """(batch with the spatial group's frames gathered by rows, this rank's
    own frames or None)."""
    if mesh is None or mesh.spatial == 1:
        return batch, None
    own = batch["frames"]
    return {**batch, "frames": all_gather_cat(own, mesh.spatial_group, 2)}, own


def _rank_noise(noise, out: Dict[str, Any], cfg: Config, mesh: Mesh | None):
    """This rank's items of the global batch's tie-break noise. A
    generator draws each scale's [B_global, H, W, n_sources] noise in the
    order and type the loss would, so the ranks together use the single
    device's noise."""
    if mesh is None or mesh.data == 1 or not cfg.use_automasking:
        return noise
    target = out["target_pyr"][0]
    b = target.shape[0]
    if isinstance(noise, torch.Generator):
        shape = (b * mesh.data, cfg.height, cfg.width, len(cfg.source_frame_ids))
        noise = {s: 1e-5 * torch.randn(shape, generator=noise, dtype=target.dtype,
                                       device=target.device)
                 for s in cfg.scales}
    first = mesh.data_index * b
    return {s: v[first:first + b] for s, v in noise.items()}


def _step_device(device, mesh: Mesh | None) -> torch.device:
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


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
             with_gt: bool = True, mesh: Mesh | None = None):
    """loss, warp_span (when computed) and, with `with_gt` and `depth_gt`
    in the batch, the 7 depth metrics; all detached. Under a mesh: the
    loss is the mean over ranks, warp_span the max over ranks (at least
    the single device's value, which means each source's span over the
    global batch), and the depth metrics are computed on the depths and
    ground truth gathered over the data group (their scale is one median
    over the batch)."""
    metrics = {"loss": loss.detach()}
    if out["warp_span"] is not None:
        metrics["warp_span"] = out["warp_span"]
    depth, gt = out["depth0"], batch.get("depth_gt")
    if mesh is not None and mesh.size > 1:
        metrics["loss"] = metrics["loss"].clone()
        dist.all_reduce(metrics["loss"])
        metrics["loss"] /= mesh.size
        if "warp_span" in metrics:
            metrics["warp_span"] = metrics["warp_span"].clone()
            dist.all_reduce(metrics["warp_span"], op=dist.ReduceOp.MAX)
        if with_gt and gt is not None and mesh.data > 1:
            depth = all_gather_cat(depth, mesh.data_group, 0)
            gt = all_gather_cat(gt, mesh.data_group, 0)
    if with_gt and gt is not None:
        metrics.update(training_depth_metric(depth.detach(), gt))
    return metrics


def make_train_step(model: Monodepth, cfg: Config, device=None,
                    sampler: Sampler | None = None, mesh: Mesh | None = None):
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
    ("train_step/forward", "train_step/backward", "train_step/optimizer").

    With `mesh`, `batch` is this rank's piece (`parallel.shard_batch`),
    `noise` is the global batch's, the step runs on the mesh's device and
    every rank must call it (module docstring); `state` must start alike
    on every rank (`parallel.replicate`)."""
    device = _step_device(device, mesh)
    warp = _spatial_warp(cfg, mesh, sampler, train=True)
    data_group = mesh.data_group if mesh is not None else None

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   noise: Mapping[int, Tensor] | None = None):
        if state.optimizer is None:
            raise ValueError("the train step needs an optimizer: build the "
                             "state with create_state(cfg, model, "
                             "steps_per_epoch=...)")
        model.train()
        batch = _to_device(batch, device)
        with record_function("train_step/forward"), \
                sync_batch_stats(model, data_group):
            batch, own_frames = _gather_frames(batch, mesh)
            out = apply_and_warp(model, batch, cfg, train=True,
                                 sampler=warp or sampler, own_frames=own_frames)
            if noise is None:
                noise = tie_noise_generator(state.seed, state.step, None, device)
            loss = _loss(out, _rank_noise(noise, out, cfg, mesh), cfg)
        with record_function("train_step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                average_gradients(model, mesh)
        with record_function("train_step/optimizer"):
            state.apply_gradients()
        return _metrics(loss, out, batch, cfg.train_gt_metrics, mesh)

    return train_step


def make_train_multi_step(model: Monodepth, cfg: Config, device=None):
    """K train steps per call (`--steps_per_call`; JAX: `lax.scan` of the
    step body over a [K, B, ...] superbatch). Returns
    multi_step(state, batches) -> {name: [K] tensor}: `batches` is a
    sequence of K consecutive batches, and the K steps run in order, each
    as `make_train_step`'s (same noise keys, same updates), so K calls of
    that step give the same state and metrics. The batches are not
    stacked: eagerly that would only add a copy. Capturing the K steps in
    a CUDA graph, which needs them in static buffers, is later work."""
    train_step = make_train_step(model, cfg, device)

    def multi_step(state: TrainState, batches: Sequence[Mapping[str, Any]]):
        metrics = [train_step(state, batch) for batch in batches]
        return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}

    return multi_step


def make_eval_step(model: Monodepth, cfg: Config, device=None,
                   sampler: Sampler | None = None, mesh: Mesh | None = None):
    """Validation step: full forward + loss + metrics, no gradient
    (reference: model_train.py:75-79).

    Returns eval_step(state, batch, index=0, noise=None) -> {name: 0-d
    tensor}: loss, warp_span (when the kernels are on) and, when the
    batch has `depth_gt`, the 7 depth metrics. `index` is the batch number
    within the pass; the tie-break noise comes from
    `tie_noise_generator(state.seed, state.step, index)` unless `noise`
    ({scale: [B, H, W, n_sources] tensor}) is given. `device` defaults to
    the card. With `mesh`, as `make_train_step`."""
    device = _step_device(device, mesh)
    warp = _spatial_warp(cfg, mesh, sampler, train=False)

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping[str, Any], index: int = 0,
                  noise: Mapping[int, Tensor] | None = None):
        model.eval()
        batch, own_frames = _gather_frames(_to_device(batch, device), mesh)
        out = apply_and_warp(model, batch, cfg, train=False,
                             sampler=warp or sampler, own_frames=own_frames)
        if noise is None:
            noise = tie_noise_generator(state.seed, state.step, index, device)
        loss = _loss(out, _rank_noise(noise, out, cfg, mesh), cfg)
        return _metrics(loss, out, batch, True, mesh)

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
