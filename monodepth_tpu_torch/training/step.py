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
With the kernels on, the loss's photometric term of each scale (SSIM+L1
of every warp, the noisy identity, the per-pixel minimum) is one forward
and one backward kernel too on a card (`_photometric`,
`ops.cuda.photometric`), except on a spatial mesh's row pieces, which
keep the plain composition, as the CPU does.
Under --remat each warp (whichever sampler) is checkpointed as in JAX:
its backward recomputes the forward, so `WarpSample` launches K1 twice.
Each step sets the model's mode itself: `.train()` for the train step
(batch statistics, running statistics updated), `.eval()` for the others.

On a card every step maker returns a step that runs as a CUDA graph
(`graph=None`; `training.graphs.GraphedStep`), the counterpart of JAX's
`jax.jit`: each call replays one captured graph. The first call of each
input shape runs eagerly, the second captures. That holds without a mesh
and on any mesh over NCCL, whose graphs hold the synced batch norm, the
gradient all-reduce, Adam, the metric reductions and on a spatial mesh
the halo exchanges, as JAX's one dispatch on a mesh holds them. A
captured spatial step warps every warp exactly on its group's gathered
rows (`_spatial_sampler` with `gather`), with the eager step's bits: the
eager step branches on the host between K3 on the rank's slab and that
exact warp, where JAX branches on the device with `lax.cond`. Two cases
stay eager, and `graph=True` raises on them, naming the reason
(`graph_refusal`): the CPU, and a gloo mesh, whose collectives run on
host tensors. `graph=False` keeps the eager step anywhere. The
graphed steps draw the tie-break noise ahead (`draw_tie_noise`; on a mesh
the global batch's, cut to this rank's items), from the same generators,
so their bits equal the eager steps'.

Under a process mesh (`parallel.make_mesh`, `mesh=`), each rank holds its
piece of the global batch (`parallel.shard_batch`) and the train and eval
steps compute what the single-device step computes on the global batch:
- data axis: batch norm normalizes with the global batch's statistics
  (`models.resnet.sync_batch_stats`), the gradients are averaged over
  the ranks, the tie-break noise is drawn for the global batch and sliced
  to this rank's items, the loss is the mean over ranks and the depth
  metrics are computed on the gathered depths;
- spatial axis: each rank holds its rows of its data row's frames and
  runs the step on them from the first op to the loss (`parallel.rows`,
  under `row_sharding`): the colour jitter's gray mean, every convolution,
  pool, pad and resize on halo-exchanged row pieces while the level rule
  holds (the deeper levels gather and run whole), batch norm summed over
  the whole mesh, the pose decoders' averages over the spatial group, the
  upsampled disparities, depths and grids of the rank's rows in the whole
  image's coordinates, each warp on a halo slab of the rank's sources
  (`_spatial_sampler`, kernel K3; the exact `spatial_fallback`, K3 on
  the gathered rows, when a tap leaves the slab or in a captured step,
  or the plain warp when the kernels are off), and SSIM and the smoothness
  with halo rows. Each rank's loss is its part of its data row's loss;
  the gradients are summed over the spatial ranks and averaged over the
  data ranks (`parallel.mesh.average_gradients`), so every rank ends
  with the same update. Only the metrics gather rows: the depths, for the
  ground-truth metrics.
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
from monodepth_tpu_torch.losses.reprojection import monodepth_loss, tie_noise
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.models.resnet import BatchNorm2d, sync_batch_stats
from monodepth_tpu_torch.ops.cuda import photometric
from monodepth_tpu_torch.ops.cuda.build import build_libraries
from monodepth_tpu_torch.ops.cuda.warp_sample import (
    SLAB,
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
from monodepth_tpu_torch.ops.sampling import downsample_2x_avg, grid_sample, resize_bilinear
from monodepth_tpu_torch.parallel import rows
from monodepth_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    average_gradients,
    exchange_halo,
)
from monodepth_tpu_torch.training.graphs import COUNTED, GraphedStep
from monodepth_tpu_torch.training.phases import backward_boundary, mark, phase
from monodepth_tpu_torch.training.state import TrainState, resolve_device

Tensor = torch.Tensor
Sampler = Callable[[Tensor, Tensor], Tensor]


def _autocast(cfg: Config, device: torch.device):
    # no cast cache: a CUDA graph cannot capture it, and the casts it saves
    # are the same values
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.precision == "bf16", cache_enabled=False)


def _to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def apply_and_warp(model: Monodepth, batch: Dict[str, Tensor], cfg: Config,
                   *, train: bool = False,
                   sampler: Sampler | None = None,
                   loss: Callable[[Dict[str, Any]], Any] | None = None):
    """Forward the model and synthesize every (scale, source) warp.

    batch: frames uint8 [B, F, H, W, 3], jitter [B, 5], K and inv_K
    [B, 4, 4] and, with the stereo frame, stereo_T [B, 4, 4], on the
    model's device. `train` only picks the default warp;
    the caller sets the model's mode and the autograd context. `sampler`
    overrides the warp (default under `cfg.use_pallas`: `WarpSample.apply`
    with `train`, `warp_sample` without; else `grid_sample`). The sources
    carry no gradient. Under `parallel.rows.row_sharding` the frames are
    this rank's rows, and so is everything that comes out: the grids in
    the whole image's coordinates, each warp by `sampler` from the rank's
    source rows. Returns disps / warped / sources /
    target_pyr / depth0 / warp_span, all f32 (or the inputs' wider type)
    whatever the network's precision; with `loss`, (those outputs,
    loss(outputs)). The train step's phases decode, networks_fwd and
    loss_fwd begin here (`training.phases`); `loss` runs inside loss_fwd,
    and the networks' outputs pass `backward_boundary`, which marks where
    their backward begins."""
    frames = batch["frames"]
    with phase("decode", frames):
        color, color_aug = decode_frames(frames, batch["jitter"])
    with phase("networks_fwd", frames):
        with _autocast(cfg, frames.device):
            outputs = model(color_aug)
        disps, poses = backward_boundary(outputs)
    with phase("loss_fwd", frames):
        out = _synthesize(model, batch, cfg, color, disps, poses, train, sampler)
        return out if loss is None else (out, loss(out))


def _synthesize(model: Monodepth, batch: Dict[str, Tensor], cfg: Config, color: Tensor,
                disps, poses, train: bool, sampler: Sampler | None) -> Dict[str, Any]:
    """`apply_and_warp`'s outputs from the networks' (`color`: the
    unaugmented frames)."""
    f32 = torch.promote_types(torch.float32, color.dtype)
    H, W = cfg.height, cfg.width
    source_ids = list(cfg.source_frame_ids)
    # contiguous, as the photometric kernels take it
    target = color[:, 0].to(f32).contiguous()

    # contiguous once: each feeds a warp per scale
    sources = [color[:, cfg.frame_ids.index(fid)].to(f32).contiguous()
               for fid in source_ids]
    # a spatial mesh's row piece: its first row in the whole image
    pieces = rows.current()
    row0 = 0 if pieces is None else pieces.row0(target.shape[1])
    full_height = None if pieces is None else H
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
        sampler = functools.partial(checkpoint, sampler, use_reentrant=False,
                                    preserve_rng_state=False)
    telemetry = cfg.use_pallas or cfg.warp_telemetry

    # on row pieces a coarse scale's level may run whole (`parallel.rows`'
    # level rule): its upsampled disparity is then split to the rank's rows
    levels = rows.resnet_levels()
    warped: Dict[int, list] = {}
    depth0 = None
    warp_span = None
    for scale in cfg.scales:
        with rows.level(levels[scale]):
            disp_full = resize_bilinear(disps[scale], H, W, align_corners=False)
        disp_full = rows.relevel(disp_full, levels[scale], True, dim=1)
        _, depth = disparity_to_depth(disp_full, cfg.min_depth, cfg.max_depth)
        if scale == 0:
            depth0 = depth
        warps = []
        for fid, src in zip(source_ids, sources):
            if fid == "s":
                T = batch["stereo_T"].to(f32)
            elif cfg.pose_type == "posecnn":
                aa, t = poses[fid]
                mean_inv_depth = rows.spatial_mean(1.0 / depth, (1, 2, 3))
                T = transform_from_parameters(
                    aa, t * mean_inv_depth[:, None],
                    invert=model.invert_for_frame(fid))
            else:
                T = transforms[fid]
            grid = warp_grid(depth, inv_K, K, T, row0, full_height)
            if telemetry and scale == 0:
                span = _warp_span(grid.detach(), row0, full_height)
                warp_span = span if warp_span is None \
                    else torch.maximum(warp_span, span)
            warps.append(sampler(src, grid))
        warped[scale] = warps

    return {
        "disps": disps,
        "warped": warped,
        "sources": sources,
        "target_pyr": _target_pyramid(target, max(cfg.scales) + 1, levels),
        "depth0": depth0,
        "warp_span": warp_span,
    }


def _warp_span(grid: Tensor, row0: int, full_height: int | None) -> Tensor:
    """`dy_span` of this rank's grid rows; of the spatial group's gathered
    rows where a rank's piece is no whole number of its 8-row slabs."""
    pieces = rows.current()
    if pieces is None or grid.shape[1] % SLAB == 0:
        return dy_span(grid, row0, full_height)
    return dy_span(all_gather_cat(grid, pieces.mesh.spatial_group, 1))


def _target_pyramid(target: Tensor, num_scales: int, levels) -> list:
    """`pyramid(target, num_scales)`; on row pieces a level that runs whole
    (`levels`, the depth network's) is made from the gathered level above."""
    out = [target]
    for s in range(1, num_scales):
        out.append(downsample_2x_avg(rows.relevel(out[-1], levels[s - 1], levels[s],
                                                  dim=1)))
    return out


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


def _k3(slab: Tensor, grid_rows: Tensor, row0: int, full_height: int,
        train: bool) -> Tensor:
    """K3 on `slab` (global rows row0 ..): `WarpSampleShifted` (gradient to
    the grid) with `train`, `warp_sample_shifted` without."""
    if train:
        return WarpSampleShifted.apply(slab, grid_rows, row0, full_height)
    return warp_sample_shifted(slab, grid_rows, row0, full_height)


def local_warp(own_rows: Tensor, from_prev: Tensor, from_next: Tensor,
               grid_rows: Tensor, s: int, full_height: int,
               train: bool) -> Tensor:
    """One rank's warp under a spatial mesh, with no collective: the slab
    [from_prev; own_rows; from_next] (halo rows from the neighbours, zeros
    at the image's edges) starts at global row s·Hl - halo, and K3 warps
    it by `grid_rows` (this rank's output rows, global coordinates), with
    `train` as `_k3`. Exact when `slab_holds_taps` holds.
    `local_warp.calls` counts it (on a CPU tensor K3 runs its plain
    version and counts no launch)."""
    local_warp.calls += 1
    halo = from_prev.shape[1]
    row0 = s * own_rows.shape[1] - halo
    slab = torch.cat([from_prev, own_rows, from_next], 1)
    return _k3(slab, grid_rows, row0, full_height, train)


def spatial_fallback(own_rows: Tensor, grid_rows: Tensor, mesh: Mesh,
                     train: bool | None = None) -> Tensor:
    """The exact warp of this rank's rows: the spatial group's rows
    gathered, then K3 on that whole image (row0 = 0) by the rank's grid
    rows, with `train` as `_k3`; with `train` None (the kernels off) the
    plain `grid_sample` (autograd to the grid), as JAX's fallback.
    `spatial_fallback.calls` counts it."""
    spatial_fallback.calls += 1
    whole = all_gather_cat(own_rows, mesh.spatial_group, 1)
    if train is None:
        return grid_sample(whole, grid_rows)
    return _k3(whole, grid_rows, 0, whole.shape[1], train)


local_warp.calls = spatial_fallback.calls = 0
COUNTED.extend([(local_warp, "calls"), (spatial_fallback, "calls")])


def _spatial_sampler(cfg: Config, mesh: Mesh, gather: bool = False):
    """The warp under a spatial mesh (counterpart of JAX's
    `_spatial_pallas_sampler`) -> sample(own_rows, grid_rows, train).

    Each rank owns Hl = H / n rows. A warp's taps stay within a few rows
    of its output row in trained regimes, so the rank sends
    halo = min(cfg.spatial_halo, Hl) edge rows to each neighbour (one
    `batch_isend_irecv`), checks that every tap lies in its slab, agrees
    on that with the group (all_reduce MIN) and runs `local_warp` (K3).
    If any rank of the group has a tap outside, all take
    `spatial_fallback` (K3 on the gathered rows). The branch is a host
    decision: the agreed flag is read with `.item()`, one device sync per
    warp.

    With `gather` (the captured steps, which cannot hold that branch)
    every warp is `spatial_fallback`, with no exchange and no flag. It
    gives the branch's bits: K3 reads the same taps and weights on the
    slab and on the gathered image wherever the slab holds the taps. It
    moves the group's rows in every warp where the slab moves 2·halo rows
    (JAX's `lax.cond` gathers in its exact branch only; an NCCL all-gather
    inside a CUDA graph's conditional node did not capture, ROADMAP §1).
    Sources carry no gradient (the warp's contract), so neither the
    exchange nor the gather has a backward."""
    n, H = mesh.spatial, cfg.height
    if H % n or H // n < 2:
        raise ValueError(f"height {H} does not split into rows of >= 2 over "
                         f"spatial={n}")
    Hl = H // n
    halo = min(cfg.spatial_halo, Hl)
    s = mesh.spatial_index

    def sample(own_rows: Tensor, grid_rows: Tensor, train: bool) -> Tensor:
        own_rows = own_rows.detach()
        if not gather:
            from_prev, from_next = exchange_halo(own_rows, halo, mesh)
            ok = slab_holds_taps(grid_rows.detach(), s * Hl - halo, Hl + 2 * halo,
                                 H).to(torch.int32).reshape(1)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.spatial_group)
            if ok.item():
                return local_warp(own_rows, from_prev, from_next, grid_rows, s, H,
                                  train)
        return spatial_fallback(own_rows, grid_rows, mesh, train)

    return sample


def _spatial_warp(cfg: Config, mesh: Mesh | None, sampler: Sampler | None,
                  train: bool, gather: bool = False) -> Sampler | None:
    """The sampler of a spatial mesh's steps -> sample(source rows, grid
    rows), both this rank's: K3 on the rank's halo slab or the gathered
    rows (`_spatial_sampler`, with `gather` as there) with the kernels on,
    the plain `spatial_fallback` without. None without a spatial axis.
    Raises when the frames' rows do not split into pieces of 3 (the
    stem's halo): the loss runs on the rank's rows at full resolution."""
    if mesh is None or mesh.spatial == 1:
        return None
    if sampler is not None:
        raise ValueError("a spatial mesh warps its rows with K3 or the exact "
                         "fallback: pass no sampler")
    with rows.row_sharding(mesh, cfg.height):
        if not rows.resnet_levels()[0]:
            raise ValueError(f"height {cfg.height} does not split into row pieces "
                             f"of >= 3 over spatial={mesh.spatial}")
    if not cfg.use_pallas:
        return lambda own_rows, grid_rows: spatial_fallback(own_rows, grid_rows, mesh)
    spatial = _spatial_sampler(cfg, mesh, gather)
    return lambda own_rows, grid_rows: spatial(own_rows, grid_rows, train)


def _stats_group(mesh: Mesh | None):
    """The process group batch norm sums its statistics over: the data
    group, or the whole mesh when it splits rows."""
    if mesh is None or mesh.spatial == 1:
        return None if mesh is None else mesh.data_group
    return dist.group.WORLD


def _rank_noise(noise, batch: Mapping[str, Tensor], cfg: Config, mesh: Mesh | None,
                device: torch.device):
    """This rank's items and rows of the global batch's tie-break noise,
    for `batch`, this rank's piece. `noise` is a generator, which draws
    each scale's [B_global, H, W, n_sources] noise on `device` in the
    order and type the loss would, or that noise already drawn ({scale:
    tensor}); so the ranks together use the single device's noise. Without
    a mesh (or automasking) `noise` is handed on as it is."""
    if mesh is None or mesh.size == 1 or not cfg.use_automasking:
        return noise
    frames = batch["frames"]
    b, h = frames.shape[0], frames.shape[2]
    if isinstance(noise, torch.Generator):
        dtype = torch.promote_types(torch.float32, batch["jitter"].dtype)
        shape = (b * mesh.data, cfg.height, cfg.width, len(cfg.source_frame_ids))
        noise = {s: tie_noise(noise, shape, dtype, device) for s in cfg.scales}
    first, row0 = mesh.data_index * b, mesh.spatial_index * h
    return {s: v[first:first + b, row0:row0 + h] for s, v in noise.items()}


def _build_kernels(cfg: Config, device: torch.device) -> None:
    """On a card, build the step's CUDA libraries ahead, all at once: the
    phase marks and, with the kernels on, the warp's and the photometric
    term's."""
    if device.type == "cuda":
        build_libraries(["phase_mark"]
                        + (["warp_sample", "photometric"] if cfg.use_pallas else []))


def _photometric(cfg: Config, mesh: Mesh | None, device: torch.device):
    """The loss's photometric term (`monodepth_loss(photometric=...)`): the
    kernels of `ops.cuda.photometric` wherever the warp kernels are on a
    card, except on a spatial mesh's row pieces, whose SSIM windows read
    halo rows exchanged with the neighbour ranks; elsewhere the plain
    composition (None)."""
    if cfg.use_pallas and device.type == "cuda" and (mesh is None or mesh.spatial == 1):
        return photometric
    return None


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


def draw_tie_noise(cfg: Config, batch: Mapping[str, Tensor], seed: int,
                   step: int, index: int | None, device: torch.device,
                   mesh: Mesh | None = None) -> Dict[int, Tensor]:
    """The tie-break noise of one step drawn ahead, {scale: [B, H, W,
    n_sources]} on `device`: `tie_noise_generator(seed, step, index)` drawn
    scale by scale in the order, shape and dtype in which `monodepth_loss`
    draws it, so a step handed this noise equals the step that draws it
    ({} without automasking). With `mesh`, `batch` is this rank's piece:
    the global batch's noise is drawn and cut to this rank's items
    (`_rank_noise`, as the eager mesh step draws it). The graphed steps
    feed it to their graphs."""
    if not cfg.use_automasking:
        return {}
    generator = tie_noise_generator(seed, step, index, device)
    if mesh is not None and mesh.size > 1:
        return _rank_noise(generator, batch, cfg, mesh, device)
    B, _, H, W, _ = batch["frames"].shape
    dtype = torch.promote_types(torch.float32, batch["jitter"].dtype)
    shape = (B, H, W, len(cfg.source_frame_ids))
    return {s: tie_noise(generator, shape, dtype, device) for s in cfg.scales}


def graph_refusal(device: torch.device, mesh: Mesh | None) -> str | None:
    """Why a step on `device` and `mesh` cannot run as a CUDA graph, or
    None when it can (module docstring)."""
    if device.type != "cuda":
        return f"a CUDA graph needs a CUDA device, not {device}"
    if mesh is None or mesh.size == 1:
        return None
    if mesh.backend != "nccl":
        return (f"a mesh over {mesh.backend or 'no process group'} cannot be "
                "captured: gloo's collectives run on host tensors; NCCL's can")
    return None


def _graphed(graph: bool | None, device: torch.device, mesh: Mesh | None) -> bool:
    """Whether a step maker captures its step: by default wherever it can
    (`graph_refusal`); `graph=True` where it cannot raises."""
    reason = graph_refusal(device, mesh)
    if graph is None:
        return reason is None
    if graph and reason is not None:
        raise ValueError(f"graph=True: {reason}")
    return bool(graph)


def _host_or_device(batch: Mapping[str, Any]) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _model_bound(model: Monodepth) -> list:
    return list(model.parameters()) + list(model.buffers())


def _train_bound(model: Monodepth, state: TrainState) -> list:
    """What a captured train step updates in place: the model's
    parameters, buffers and gradients, Adam's state and its rate."""
    optimizer = state.optimizer
    return (_model_bound(model) + [p.grad for p in model.parameters()]
            + [v for entry in optimizer.state.values() for v in entry.values()
               if isinstance(v, Tensor)]
            + [group["lr"] for group in optimizer.param_groups])


def _forward(model: Monodepth, batch: Dict[str, Tensor], noise, cfg: Config,
             mesh: Mesh | None, train: bool, sampler: Sampler | None,
             choices: bool = False):
    """A step's forward and loss on this rank's piece -> (apply_and_warp's
    outputs, loss, the loss's terms): under a mesh batch norm sums over
    its ranks, and a spatial mesh runs on this rank's rows
    (`parallel.rows.row_sharding`); the loss is this rank's part. `noise`
    is this rank's (`_rank_noise`), or a generator without a mesh."""
    with sync_batch_stats(model, _stats_group(mesh)), \
            rows.row_sharding(mesh, cfg.height):
        out, (loss, aux) = apply_and_warp(
            model, batch, cfg, train=train, sampler=sampler,
            loss=lambda out: monodepth_loss(
                out["disps"], out["warped"], out["sources"], out["target_pyr"],
                noise, scales=cfg.scales,
                disp_smoothness=cfg.disp_smoothness,
                use_automasking=cfg.use_automasking, choices=choices,
                photometric=_photometric(cfg, mesh, batch["frames"].device)))
    return out, loss, aux


@torch.no_grad()
def loss_choices(model: Monodepth, cfg: Config, batch: Mapping[str, Any], noise,
                 mesh: Mesh | None = None, device=None) -> Dict[int, Tensor]:
    """{scale: [b, h, W] int64}: the channel each pixel's minimum takes
    (identity channels first) in a train step's forward from the model's
    state on this rank's piece (`noise` as the train step takes it), the
    running statistics left as they are. `parallel.run_steps --reference`
    counts where a mesh's choices differ from one device's."""
    device = _step_device(device, mesh)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    model.train()
    for m in norms:
        m.keep_stats = True
    try:
        batch = _to_device(batch, device)
        _, _, aux = _forward(model, batch, _rank_noise(noise, batch, cfg, mesh, device),
                             cfg, mesh, True, _spatial_warp(cfg, mesh, None, train=True),
                             choices=True)
    finally:
        for m in norms:
            m.keep_stats = False
    return {s: aux[f"choice/{s}"] for s in cfg.scales}


@torch.no_grad()
def _metrics(loss: Tensor, out: Dict[str, Any], batch: Dict[str, Tensor],
             with_gt: bool = True, mesh: Mesh | None = None):
    """loss, warp_span (when computed) and, with `with_gt` and `depth_gt`
    in the batch, the 7 depth metrics; all detached. Under a mesh: the
    loss is the sum of the ranks' parts over the data ranks (the mean of
    the data rows' losses), warp_span the max over ranks (at least the
    single device's value, which means each source's span over the global
    batch), and the depth metrics are computed on the depths gathered by
    rows over the spatial group and, with the ground truth, over the data
    group (their scale is one median over the batch)."""
    metrics = {"loss": loss.detach()}
    if out["warp_span"] is not None:
        metrics["warp_span"] = out["warp_span"]
    depth, gt = out["depth0"], batch.get("depth_gt")
    if mesh is not None and mesh.size > 1:
        metrics["loss"] = metrics["loss"].clone()
        dist.all_reduce(metrics["loss"])
        metrics["loss"] /= mesh.data
        if "warp_span" in metrics:
            metrics["warp_span"] = metrics["warp_span"].clone()
            dist.all_reduce(metrics["warp_span"], op=dist.ReduceOp.MAX)
        if with_gt and gt is not None and mesh.spatial > 1:
            depth = all_gather_cat(depth, mesh.spatial_group, 1)
        if with_gt and gt is not None and mesh.data > 1:
            depth = all_gather_cat(depth, mesh.data_group, 0)
            gt = all_gather_cat(gt, mesh.data_group, 0)
    if with_gt and gt is not None:
        metrics.update(training_depth_metric(depth.detach(), gt))
    return metrics


def _check_optimizer(state: TrainState) -> None:
    if state.optimizer is None:
        raise ValueError("the train step needs an optimizer: build the "
                         "state with create_state(cfg, model, "
                         "steps_per_epoch=...)")


def _train_runner(model: Monodepth, cfg: Config, device: torch.device,
                  sampler: Sampler | None, mesh: Mesh | None, graphed: bool = False):
    """run(state, batch on the device, noise, lr=None) -> metrics: one
    train step's body (`noise` as `_forward` takes it; the lr tensor, when
    given, replaces schedule(step): `TrainState.apply_gradients`); with
    `graphed`, the body a capture records (a spatial mesh's warps gather).
    Each phase of the step begins with its range and mark
    (`training.phases`), in the order of `PHASES`."""
    sampler = _spatial_warp(cfg, mesh, sampler, train=True, gather=graphed) or sampler
    _build_kernels(cfg, device)

    def run(state: TrainState, batch: Dict[str, Tensor], noise, lr=None):
        model.train()
        out, loss, _ = _forward(model, batch, noise, cfg, mesh, True, sampler)
        with phase("loss_bwd", loss):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if mesh is not None:
            with phase("grad_sync", loss):
                average_gradients(model, mesh)
        with phase("optimizer", loss):
            state.apply_gradients(lr)
        with phase("metrics", loss):
            metrics = _metrics(loss, out, batch, cfg.train_gt_metrics, mesh)
        mark("end", loss.device)
        return metrics

    return run


def _train_calls(run, state: TrainState, inputs: Mapping[str, Any]) -> list:
    """What a captured train step runs: `run` (`_train_runner`) once per
    step of `inputs` (`_train_inputs`, their tensors on the device) ->
    [metrics of each step]."""
    return [run(state, batch, noise, lr) for batch, noise, lr
            in zip(inputs["batches"], inputs["noise"], inputs["lr"])]


def _train_inputs(cfg: Config, state: TrainState, batches: Sequence[Mapping[str, Any]],
                  noises: Sequence[Mapping[int, Tensor]] | None,
                  device: torch.device, mesh: Mesh | None = None) -> Dict[str, Any]:
    """The inputs of K captured train steps: the K batches (host or device
    tensors; with `mesh`, this rank's pieces), their tie-break noise cut
    to this rank (`noises`, the global batches', else `draw_tie_noise` at
    steps state.step + k) and their learning rates schedule(state.step +
    k), which become 0-d f32 tensors on the card (`training.graphs`)."""
    batches = [_host_or_device(b) for b in batches]
    if noises is None:
        noises = [draw_tie_noise(cfg, b, state.seed, state.step + k, None, device, mesh)
                  for k, b in enumerate(batches)]
    else:
        noises = [_rank_noise(dict(n), b, cfg, mesh, device)
                  for n, b in zip(noises, batches)]
    return {"batches": batches, "noise": [dict(n) for n in noises],
            "lr": [float(state.schedule(state.step + k)) for k in range(len(batches))]}


def _graphed_train(model: Monodepth, cfg: Config, device: torch.device,
                   sampler: Sampler | None, mesh: Mesh | None):
    """steps(state, batches, noises=None) -> [metrics of each step]: the K
    = len(batches) train steps of one call as one CUDA graph, a graph per
    K and batch shape; on a mesh with its collectives inside.
    The graph is bound to the `TrainState` of the first call; another
    state raises. Each call draws the K steps' tie-break noise
    (`draw_tie_noise`, steps state.step + k) unless `noises` are given,
    and hands in the K learning rates schedule(state.step + k)."""
    run = _train_runner(model, cfg, device, sampler, mesh, graphed=True)
    bound = {}
    graphed = GraphedStep(lambda inputs: _train_calls(run, bound["state"], inputs),
                          device, lambda: _train_bound(model, bound["state"]))

    @record_function("train_step/call")
    def steps(state: TrainState, batches, noises=None):
        _check_optimizer(state)
        if not bound:
            if state.model is not model:
                raise ValueError("the state's model is not the step's model")
            if not all(isinstance(g["lr"], Tensor) and g["capturable"]
                       for g in state.optimizer.param_groups):
                raise ValueError("a captured train step needs capturable Adam "
                                 "with a tensor learning rate (make_optimizer "
                                 "on a CUDA device)")
            bound["state"] = state
        elif state is not bound["state"]:
            raise ValueError("this captured train step is bound to the "
                             "TrainState of its first call; make another "
                             "step for another state")
        inputs = _train_inputs(cfg, state, batches, noises, device, mesh)
        model.train()
        return graphed(inputs, state, steps=len(batches))

    return steps


def make_train_step(model: Monodepth, cfg: Config, device=None,
                    sampler: Sampler | None = None, mesh: Mesh | None = None,
                    graph: bool | None = None):
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
    tensor}) is given. `device` defaults to the card. Each phase of the
    step (`training.phases.PHASES`) is a `torch.profiler` range
    "train_step/<phase>" of the eager step and of a capture, and on a card
    begins with an empty kernel `phase_mark_<phase>`, which every replay
    runs too; a captured call is the range "train_step/call".

    `graph` (module docstring): on a card, without a mesh or on a mesh
    over NCCL, the step is a CUDA graph, bound to the `TrainState` of its
    first call.

    With `mesh`, `batch` is this rank's piece (`parallel.shard_batch`),
    `noise` is the global batch's, the step runs on the mesh's device and
    every rank must call it (module docstring); `state` must start alike
    on every rank (`parallel.replicate`)."""
    device = _step_device(device, mesh)
    if _graphed(graph, device, mesh):
        steps = _graphed_train(model, cfg, device, sampler, mesh)

        def graphed_step(state: TrainState, batch: Mapping[str, Any],
                         noise: Mapping[int, Tensor] | None = None):
            return steps(state, [batch], None if noise is None else [noise])[0]

        return graphed_step
    run = _train_runner(model, cfg, device, sampler, mesh)

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   noise: Mapping[int, Tensor] | None = None):
        _check_optimizer(state)
        if noise is None:
            noise = tie_noise_generator(state.seed, state.step, None, device)
        batch = _to_device(batch, device)
        return run(state, batch, _rank_noise(noise, batch, cfg, mesh, device))

    return train_step


def make_train_multi_step(model: Monodepth, cfg: Config, device=None,
                          mesh: Mesh | None = None, graph: bool | None = None):
    """K train steps per call (`--steps_per_call`; JAX: `lax.scan` of the
    step body over a [K, B, ...] superbatch). Returns
    multi_step(state, batches) -> {name: [K] tensor}: `batches` is a
    sequence of K consecutive batches (this rank's pieces, with `mesh`),
    and the K steps run in order, each as `make_train_step`'s (same noise
    keys, same updates), so K calls of that step give the same state and
    metrics. Where `make_train_step` captures (`graph`) the K steps are
    one CUDA graph, the counterpart of the scan: one replay a call, with K
    gradient all-reduces inside on a mesh. Eagerly they are K steps; the
    batches are not stacked, which would only add a copy."""
    device = _step_device(device, mesh)
    if _graphed(graph, device, mesh):
        steps = _graphed_train(model, cfg, device, None, mesh)
    else:
        train_step = make_train_step(model, cfg, device, mesh=mesh, graph=False)

        def steps(state, batches):
            return [train_step(state, batch) for batch in batches]

    def multi_step(state: TrainState, batches: Sequence[Mapping[str, Any]]):
        metrics = steps(state, list(batches))
        return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}

    return multi_step


def make_eval_step(model: Monodepth, cfg: Config, device=None,
                   sampler: Sampler | None = None, mesh: Mesh | None = None,
                   graph: bool | None = None):
    """Validation step: full forward + loss + metrics, no gradient
    (reference: model_train.py:75-79).

    Returns eval_step(state, batch, index=0, noise=None) -> {name: 0-d
    tensor}: loss, warp_span (when the kernels are on) and, when the
    batch has `depth_gt`, the 7 depth metrics. `index` is the batch number
    within the pass; the tie-break noise comes from
    `tie_noise_generator(state.seed, state.step, index)` unless `noise`
    ({scale: [B, H, W, n_sources] tensor}) is given. `device` defaults to
    the card. `graph` as `make_train_step`'s; the graph reads `state` for
    its noise keys only. With `mesh`, as `make_train_step`."""
    device = _step_device(device, mesh)
    graphed = _graphed(graph, device, mesh)
    sampler = _spatial_warp(cfg, mesh, sampler, train=False, gather=graphed) or sampler
    _build_kernels(cfg, device)

    def run(batch: Dict[str, Tensor], noise):
        model.eval()
        out, loss, _ = _forward(model, batch, noise, cfg, mesh, False, sampler)
        return _metrics(loss, out, batch, True, mesh)

    if graphed:
        graphed = GraphedStep(lambda inputs: run(inputs["batch"], inputs["noise"]),
                              device, lambda: _model_bound(model))

        @torch.inference_mode()
        def graphed_step(state: TrainState, batch: Mapping[str, Any],
                         index: int = 0, noise: Mapping[int, Tensor] | None = None):
            batch = _host_or_device(batch)
            if noise is None:
                noise = draw_tie_noise(cfg, batch, state.seed, state.step, index,
                                       device, mesh)
            else:
                noise = _rank_noise(dict(noise), batch, cfg, mesh, device)
            model.eval()
            return graphed({"batch": batch, "noise": dict(noise)})

        return graphed_step

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping[str, Any], index: int = 0,
                  noise: Mapping[int, Tensor] | None = None):
        if noise is None:
            noise = tie_noise_generator(state.seed, state.step, index, device)
        batch = _to_device(batch, device)
        return run(batch, _rank_noise(noise, batch, cfg, mesh, device))

    return eval_step


class DepthInference(torch.nn.Module):
    """Depth-only inference as a module: images [B, H, W, 3] in [0, 1] ->
    scaled disparity [B, H, W], converted with the eval depth range 1e-3
    to 80 whatever the training range (reference: model_test.py:80-83),
    the network under bf16 autocast with --precision bf16. The infer step
    runs it, and `tools/export_inference.py` exports it."""

    def __init__(self, model: Monodepth, cfg: Config):
        super().__init__()
        self.model = model
        self.bf16 = cfg.precision == "bf16"

    def forward(self, images: Tensor) -> Tensor:
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16, cache_enabled=False):
            disps = self.model.depth(images)
        scaled_disp, _ = disparity_to_depth(disps[0].float(), 1e-3, 80.0)
        return scaled_disp[..., 0]


def make_infer_step(model: Monodepth, cfg: Config, device=None,
                    graph: bool | None = None):
    """Depth-only batched inference: infer(images [B, H, W, 3] in [0, 1])
    -> scaled disparity [B, H, W] (`DepthInference`, the model in eval
    mode). `device` defaults to the card. `graph` as `make_train_step`'s:
    on a card a graph per batch shape."""
    device = resolve_device(device)
    module = DepthInference(model, cfg)

    def run(images: Tensor) -> Tensor:
        return module(images.to(device, torch.float32))

    graphed = GraphedStep(run, device, lambda: _model_bound(model)) \
        if _graphed(graph, device, None) else run

    @torch.inference_mode()
    def infer(images) -> Tensor:
        model.eval()
        return graphed(torch.as_tensor(images))

    return infer
