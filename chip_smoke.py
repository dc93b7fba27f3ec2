#!/usr/bin/env python3
"""Build and run the PyTorch port on one CUDA card, and check it.

    python3 chip_smoke.py    # every phase below; phase 7 needs 2 or more cards

Run from a checkout of the repository on a host with one NVIDIA Hopper
card and the CUDA toolkit. It exits non-zero, and prints no result, when
no card is present or when it runs without the repository beside it.
Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi); build every CUDA kernel
   from `monodepth_tpu_torch/csrc/`, one nvcc per source, all at once;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, on smooth, wild and NaN/inf fields and
   one odd shape: max |diff| <= 1e-6, NaN exactly where the plain
   version has NaN. For the train form (K1) also ragged widths and
   pointers off 16 bytes (max |diff| 0), and
   the gradient with respect to the grid through `WarpSample`, kernels
   against plain versions: max |diff| <= 1e-6 · max(scale, 1). Its
   backward (K1-bwd, `grid_vjp`) against `grid_vjp_reference` on K1's
   outputs at the main path's shape, at the {spatial: 2} shard (Hout 96
   of 192) and one odd shape, on pointers off 16 bytes and an expanded
   cotangent: max |diff| <= 1e-6 · max(scale, 1), NaN where the plain
   version has NaN;
3. each kernel's device time (CUDA events around replays of a CUDA
   graph of 40 calls, warmed, rotating inputs larger than L2), beside
   its bound, its plain version's time and, where one PyTorch call
   computes the same function, that call's time; for K1 also the
   forward and backward of `WarpSample` beside `F.grid_sample`'s forward
   and backward with respect to the grid; for K1-bwd
   `aten.grid_sampler_2d_backward` (grid gradient only) as the library
   call. The eager times, host launch cost included, are printed beside
   them;
4. the warp-gather probes (`ops/cuda/probes.py`, P-A to P-D): each kernel
   against its plain version at the probe tool's shapes and inputs, at
   the CPU tests' shapes with out-of-range indices, and at one odd shape:
   equal exactly, NaN exactly where the plain version has NaN (P-D also
   at every n_y 1-8 at the tool's shape, on int32-extreme indices and at
   the widest rows one block's shared memory holds); each
   kernel's device time as in phase 3 (rotating inputs larger than L2 for
   P-D; its coalesced-index and L2-warm times beside), beside its bound
   from this run's inputs, the launch floor (a one-element in-place add
   by the same replay), its plain version's time
   and the library call's; then the probe tool's path,
   `kernel_probe.main()`, with the launch counts set to 0 just before and
   read just after (P-A, P-B, P-C once each, P-D 52 times): A-C equal to
   the plain versions on the tool's inputs, D's time finite;
5. the main path: `build_model(Config())` (ResNet-18, separate pose,
   640x192, batch 12, bf16) from a seeded init on `make_planar_scenes`,
   through the public entry points, each path with the launch counts set
   to 0 just before it and read just after:
   a. train: `create_state(..., steps_per_epoch=100)`, 3 train steps
      (losses finite, every parameter changed, 24 K1 and 24 K1-bwd
      launches, no K2); then one step from a deep copy of the model and
      optimizer with the plain warp (forward and backward) and the same
      noise (loss rtol 1e-5, per-module gradient rel-L2 <= 1e-3, cuDNN
      deterministic for that pair); the step's time and profile (K1 and
      K1-bwd device ms, kernels per step, device ms under
      `WarpSampleBackward`);
   b. eval and infer, on the trained model: 3 eval steps and 3 infer
      batches (24 K2 launches, no K1, running statistics unchanged); then
      one eval step again with the plain warp, loss rtol 1e-5;
6. the shifted warp kernel K3 (`warp_sample_shifted`, eval form, and
   `warp_sample_grads_shifted`, train form):
   a. against its plain version at the slabs of the {spatial: 2} and
      {spatial: 4} meshes at 640x192 b12 (224- and 144-row slabs, every
      shard), on smooth, wild and NaN/inf fields, and one odd shape:
      max |diff| <= 1e-6, NaN where the plain version has NaN;
   b. the one-card spatial path: the grids and sources of one headline
      train step (a copy of the trained state), and for n in {2, 4} every
      rank's `local_warp` with the halo rows cut from the whole image as
      the exchange delivers them, in train form (forward, and backward
      with a fixed dout) and eval form, with the launch counts set to 0
      just before and read just after (48 launches of each form, and 56
      of K1-bwd: the shards' 48 and the whole image's 8): the stitched
      output equals `WarpSample`/`warp_sample` on the whole image (max
      |diff| 0), the dgrid within 1e-6 · max(scale, 1);
   c. its device time at the {spatial: 2} slab (as phase 3), beside its
      bound from this run's taps, its plain version's time, K1/K2's on the
      whole image and `F.grid_sample` on the slab;
7. with 2 or more cards: `parallel.run_steps` over NCCL at the headline
   config, {spatial: 2} on 2 cards and {data: 2, spatial: 2} on 4 (2
   train steps and an eval step), in f32 and bf16, each rank's K3 and
   K1-bwd launches checked (its counts set to 0 just before the steps:
   one K1-bwd per train-form K3, 16 without fallbacks) and the
   mesh against the one-card step on the global batch: losses f32 rtol
   1e-5, bf16 rtol 1e-4 or the one card's own bf16-vs-f32 loss gap of
   this run where larger; bf16 first-step gradients, module by module,
   rel-L2 <= the one card's own bf16-vs-f32 gradient rel-L2 of this run
   (at least 1e-3). With one card it prints that it did not run;
8. the KITTI host data path and the Eigen CLI, on one card at the
   headline config (full width and depth, bf16), under `build/phase8/`:
   a. a `make_kitti_tree` tree at KITTI's native 375x1242 (26 frames, both
      cameras), 48 train lines and a 46-line test list;
   b. the seeded model's encoder and decoder as official-layout
      `encoder.pth`/`depth.pth`, converted by `python -m
      monodepth_tpu_torch.tools.convert_torch_weights monodepth2`, then
      `python -m monodepth_tpu_torch.model_test --eval_batch 16
      --save_pred_disps` (batches 16, 16, 14): the table prints, the saved
      disparities equal `make_infer_step` on the same frames in the same
      batches (max |diff| <= 1e-3 · max |disp|), `eigen_metrics` of them
      is the printed row;
   c. `KittiDataset` (training, GT) batches of 12 through `Loader` and
      `prefetch_to_device` into 2 train steps (16 K1, 16 K1-bwd launches)
      and 2 eval steps (16 K2 launches, depth metrics finite), counts set
      to 0 just before each path; every batch on the card equal to the
      host arrays; one eval step again with the plain warp, loss rtol 1e-5;
   d. one --remat train step from a deep copy against one without: loss
      rtol 1e-5, per-module gradient rel-L2 <= 1e-3, running statistics
      equal and counted once, K1 16 launches against 8, the peak memory
      of each;
   e. loader batches/s (native decoder and PIL), GT projection ms/image,
      the Eigen sweep's images/s, the peak memory with and without remat;
9. the Trainer at the headline config on phase 8's tree (48 train lines,
   24 validation lines: 4 train and 2 validation steps an epoch), under
   `build/phase9/`:
   a. `python -m monodepth_tpu_torch.model_train --epoch 2 --ckpt_every 1
      --eigen_every 1 --weight_init true` with a seeded torchvision-layout
      `resnet18.pth` in `--pretrained_dir`: exit 0, two records with
      finite losses and Eigen blocks, `state_0000.pt`, `state_0001.pt`
      and the module exports of both epochs; `Trainer.__init__` with the
      same flags holds the .pth's conv1 (tiled for the pose encoder);
      `model_test` on the epoch-2 export prints the last in-training
      sweep within 1e-3 · max |metric| + 5e-4 (the printed digit);
   b. cuDNN deterministic: 2 epochs against 1 and then a resume, max
      |diff| 0 over parameters, buffers and Adam state, records equal but
      their times (on failure, the ops that
      `torch.use_deterministic_algorithms` names);
   c. the 2-epoch run with every kernel's count set to 0 just before
      `train()`: K1 and K1-bwd 8 per train step, K2 8 per validation
      step, K3 and the probes 0, and no call of a plain version;
   d. `--steps_per_call 2` against 1 (state max |diff| 0, records equal);
      then, with cuDNN as in phase 5a, on epochs of 24 train steps (the
      train lines 6 times over): the Trainer's own loader alone over one
      epoch, and the Trainer's img/s in its second epoch, with 8 and 4
      loader threads and with `--cache_frames`, beside phase 5a's step
      rate and the rate of the step and the loader run one after the
      other;
   e. the mono convergence proof (`tools/convergence_proof.py`, 600 steps
      at 96x320 b8, `--use_pallas true --tx_sign 1`): it passes its rule,
      with 4800 launches of K1 and of K1-bwd;
   f. K1's device time (as phase 3) on fields whose vertical offsets span
      about 14, 40 and 60 px and on +-50 px noise;
10. the other pose wirings and stereo at the headline config (640x192,
   b12, bf16, ResNet-18 at full width and depth, weights from
   `cfg.seed`, `make_planar_scenes` frames; for "s" the +1 view again
   with its seeded baseline as `stereo_T`):
   a. for `shared`, `posecnn`, `separate` with `pose_frames="all"` and
      mono+stereo `separate` (frames 0, -1, 1, "s"): one train step with
      the kernels and one from a deep copy with the plain warp (loss rtol
      1e-5, per-module gradient rel-L2 <= 1e-3, cuDNN deterministic for
      the pair), K1 and K1-bwd launched once per warp (8, or 12 with
      "s") and no plain version called; one eval step, K2 8 or 12
      launches, loss rel <= 1e-5 against the plain warp;
   b. the mono+stereo train step's host ms (median of 10) and device-busy
      ms (torch.profiler) beside phase 5a's mono step;
   c. one ResNet-50 `separate` train step with the kernels: finite loss,
      8 K1 and 8 K1-bwd launches, its host ms;
   d. the stereo convergence proof (`tools/convergence_proof.py --mode
      stereo`, 600 steps at 96x320 b8, `--use_pallas true`): it passes its
      rule, with 2400 launches of K1 and of K1-bwd;
11. the `kernels` JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
   K3's launches there are those of phase 7's largest mesh in bf16 (rank
   0) when phase 7 ran, else phase 6b's one-card per-rank emulation;
   "launches_on" says which. K1, K1-bwd and K2 also carry their launches
   on phase 8c's loader path ("launches_loader_path"), and every kernel
   its launches in phase 9c's Trainer run ("launches_trainer_path") and
   in phase 10a's kernel steps of the four wirings
   ("launches_wirings_path").
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_RATE = 3.35e12  # bytes/s, H100 SXM HBM3 (NVIDIA data sheet)
F32_RATE = 67e12    # flop/s, H100 SXM float32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(moved_bytes: float, flops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate."""
    t_bytes, t_ops = moved_bytes / MEM_RATE, flops / F32_RATE
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def cuda_ms(fn, inputs, repeat: int, warmup: int = 5) -> float:
    """Mean ms per eager call of fn(*inputs[i % len(inputs)]), by CUDA
    events. Where the host's launch cost exceeds the device time, this
    measures the host."""
    import torch

    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(repeat):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def graph_ms(fn, inputs, calls: int = 40, replays: int = 10) -> float:
    """Device ms per call of fn(*inputs[i % len(inputs)]): `calls` calls
    captured in one CUDA graph, replayed `replays` times between CUDA
    events, so the host's launch cost stays out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for i in range(3):
            fn(*inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_ms(torch, fn, n: int = 10) -> float:
    """Median host-clock ms of fn(i), each call ended by a synchronize."""
    import numpy as np

    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def warp_fields(rng, B, H, W):
    """Smooth displacement field, a wild (uniform, out-of-bounds) one and
    the smooth one with NaN/inf entries, as [B, H, W, 2] float32."""
    import numpy as np

    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = (xs + 6.0 * np.sin(xs / 17.0 + ys / 23.0)) / (W - 1) * 2 - 1
    gy = (ys + 1.5 * np.cos(ys / 7.0 + xs / 31.0)) / (H - 1) * 2 - 1
    smooth = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    wild = rng.uniform(-2.5, 2.5, smooth.shape).astype(np.float32)
    nan = smooth.copy()
    nan[0, 1, 2] = np.nan
    nan[0, 4, 5, 1] = np.inf
    nan[B - 1, H - 1, W - 1, 0] = -np.inf
    return {"smooth": smooth, "wild": wild, "nan": nan}


def timing_sets(torch, rng, dev, B, H, W, C):
    """Four input sets (~330 MB, larger than L2) at the main path's shape
    on the smooth field: (image NHWC, grid, image NCHW, dout NHWC,
    dout NCHW)."""
    import numpy as np

    fields = warp_fields(rng, B, H, W)["smooth"]
    sets = []
    for _ in range(4):
        im = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(dev)
        gr = torch.from_numpy(fields + rng.uniform(-1e-3, 1e-3, fields.shape)
                              .astype(np.float32)).to(dev)
        dout = torch.from_numpy(rng.standard_normal((B, H, W, C))
                                .astype(np.float32)).to(dev)
        sets.append((im, gr, im.permute(0, 3, 1, 2).contiguous(), dout,
                     dout.permute(0, 3, 1, 2).contiguous()))
    return sets


def compare(name, ours, plain, nan_pixels=None) -> float:
    """max |kernel - plain| over tensors of one call, NaN patterns equal."""
    err = 0.0
    for i, (a, b) in enumerate(zip(ours, plain)):
        check(bool((a.isnan() == b.isnan()).all()),
              f"{name} output {i}: NaN pattern differs from the plain version")
        if nan_pixels is not None:
            n = int(a.isnan().any(-1).sum())
            check(n == nan_pixels, f"{name} output {i}: {n} NaN pixels, "
                  f"expected {nan_pixels}")
        err = max(err, float((a - b).nan_to_num().abs().max()))
    return err


def phase_kernels(torch, dev, ws, cfg, card):
    """Phases 2 and 3 for the eval-form warp kernel (K2). Returns its
    `kernels` entry (launches filled in by the main path)."""
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    B, H, W, C = cfg.batch, cfg.height, cfg.width, 3
    img = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(dev)
    max_err = 0.0
    for name, field in warp_fields(rng, B, H, W).items():
        grid = torch.from_numpy(field).to(dev)
        out = ws.warp_sample(img, grid)
        plain = ws.warp_sample_reference(img, grid)
        torch.cuda.synchronize()
        # +-inf coordinates clamp to the border: only the NaN pixel is NaN
        err = compare(f"warp_sample {name}", [out], [plain],
                      1 if name == "nan" else None)
        log(f"warp_sample vs plain, {name} {B}x{H}x{W}x{C}: max|diff| = {err:.3e}")
        check(err <= 1e-6, f"warp_sample {name}: max|diff| {err} > 1e-6")
        if name == "nan":
            check(bool(out[0, 1, 2].isnan().all()), "NaN coordinate did not give NaN")
        max_err = max(max_err, err)
    # one shape the TPU kernel never took
    oi = torch.from_numpy(rng.uniform(size=(3, 7, 33, 4)).astype(np.float32)).to(dev)
    og = torch.from_numpy(warp_fields(rng, 3, 7, 33)["wild"]).to(dev)
    err = float((ws.warp_sample(oi, og) - ws.warp_sample_reference(oi, og)).abs().max())
    log(f"warp_sample vs plain, odd 3x7x33x4: max|diff| = {err:.3e}")
    check(err <= 1e-6, f"warp_sample odd shape: max|diff| {err} > 1e-6")

    # phase 3: times at the main path's shape; inputs rotate so each launch
    # finds its data cold in L2
    sets = timing_sets(torch, rng, dev, B, H, W, C)
    fns = {"kernel": lambda im, gr, *_: ws.warp_sample(im, gr),
           "plain": lambda im, gr, *_: ws.warp_sample_reference(im, gr),
           "library": lambda _, gr, nchw, *__: F.grid_sample(
               nchw, gr, mode="bilinear", padding_mode="border",
               align_corners=True)}
    device_ms = {k: graph_ms(fn, sets) for k, fn in fns.items()}
    eager_ms = {k: cuda_ms(fn, sets, 40 if k == "plain" else 400)
                for k, fn in fns.items()}
    npx = B * H * W
    bound_ms, bound_by = bound(npx * (2 * 4 + 2 * C * 4),  # grid + image + out
                               npx * (10 + 9 * C))         # coords + 3 lerps
    log(json.dumps({"warp_sample_fwd_us": device_ms["kernel"] * 1e3,
                    "bound_us": bound_ms * 1e3,
                    "plain_ms": device_ms["plain"],
                    "library_ms": device_ms["library"],
                    "library": "F.grid_sample(border, align_corners=True), NCHW",
                    "timing": "device, CUDA graph of 40 calls x 10 replays",
                    "eager_ms": eager_ms,
                    "eager_timing": "CUDA events around eager calls (host launch cost included)",
                    "shape": f"{B}x{H}x{W}x{C} f32", "card": card}))
    return {"name": "warp_sample_fwd", "route": "cuda",
            "source": "monodepth_tpu_torch/csrc/warp_sample.cu",
            "replaces": "monodepth_tpu/ops/pallas/warp_sample.py:109",
            "launches": None, "max_abs_err": max_err, "ms": device_ms["kernel"],
            "plain_ms": device_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": device_ms["library"]}


def offset_copy(torch, t):
    """A contiguous copy of `t` that starts 4 bytes past a 16-byte
    boundary, so the kernels take their one-pixel-at-a-time path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    check(out.data_ptr() % 16 != 0 and out.is_contiguous(), "offset copy is aligned")
    return out


def pixel_group_cases(torch, dev, ws, rng) -> float:
    """Phase 2 for K1's pixel groups: ragged widths (groups across rows, a
    ragged last group) and pointers off 16 bytes, each against the plain
    version: max |diff| 0."""
    import numpy as np

    worst = 0.0
    for B, H, W in ((12, 192, 33), (12, 192, 130), (3, 17, 33)):
        img = torch.from_numpy(rng.uniform(size=(B, H, W, 3)).astype(np.float32)).to(dev)
        for name, field in warp_fields(rng, B, H, W).items():
            grid = torch.from_numpy(field).to(dev)
            err = compare(f"warp_sample_grads {name} {B}x{H}x{W}",
                          ws.warp_sample_grads(img, grid),
                          ws.warp_sample_grads_reference(img, grid))
            log(f"warp_sample_grads vs plain, {name} {B}x{H}x{W}x3 "
                f"({B * H * W % 2} px in the last group of 2): max|diff| = {err:.3e}")
            check(err == 0, f"warp_sample_grads {name} {B}x{H}x{W}: max|diff| {err}")
            worst = max(worst, err)
    img = torch.from_numpy(rng.uniform(size=(12, 192, 640, 3)).astype(np.float32)).to(dev)
    grid = torch.from_numpy(warp_fields(rng, 12, 192, 640)["wild"]).to(dev)
    plain = ws.warp_sample_grads_reference(img, grid)
    out = ws.warp_sample_grads(offset_copy(torch, img), offset_copy(torch, grid))
    err = compare("warp_sample_grads off 16 bytes", out, plain)
    log("warp_sample_grads vs plain, wild 12x192x640x3, image and grid 4 bytes "
        f"off 16: max|diff| = {err:.3e}")
    check(err == 0, f"warp_sample_grads off 16 bytes: max|diff| {err}")
    return max(worst, err)


def phase_grid_vjp_kernel(torch, dev, ws, cfg, card):
    """Phases 2 and 3 for the train form's backward (K1-bwd, `grid_vjp`).
    Returns its `kernels` entry."""
    import numpy as np

    rng = np.random.default_rng(5)
    B, H, W, C = cfg.batch, cfg.height, cfg.width, 3
    img = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(dev)
    fields = warp_fields(rng, B, H, W)
    n, s = 2, 1
    Hl, halo = H // n, min(cfg.spatial_halo, H // n)
    own, prev, nxt, row0 = spatial_slab(img, s, n, halo)
    slab = torch.cat([prev, own, nxt], 1)
    cases = []  # (label, grid, gx, gy, full height)
    for name, field in fields.items():
        grid = torch.from_numpy(field).to(dev)
        cases.append((f"{name} {B}x{H}x{W}x{C}", grid, *ws.warp_sample_grads(img, grid)[1:], H))
        rows = grid[:, s * Hl:(s + 1) * Hl].contiguous()
        cases.append((f"{name} {{spatial: 2}} shard 1, Hout {Hl} of {H}", rows,
                      *ws.warp_sample_grads_shifted(slab, rows, row0, H)[1:], H))
    oi = torch.from_numpy(rng.uniform(size=(3, 7, 33, 4)).astype(np.float32)).to(dev)
    og = torch.from_numpy(fields["wild"][:3, :7, :33].copy()).to(dev)
    cases.append(("odd 3x7x33x4", og, *ws.warp_sample_grads(oi, og)[1:], 7))
    max_err = 0.0
    for label, grid, gx, gy, full in cases:
        dout = torch.from_numpy(rng.standard_normal(tuple(gx.shape)).astype(np.float32)).to(dev)
        plain = ws.grid_vjp_reference(grid, dout, gx, gy, full)
        runs = {"": (ws.grid_vjp(grid, dout, gx, gy, full), plain)}  # (kernel, plain)
        if label.startswith("wild") and "shard" not in label:
            wide = dout[:, :1, :1].expand_as(dout)
            runs[", every input 4 bytes off 16"] = (ws.grid_vjp(
                *(offset_copy(torch, t) for t in (grid, dout, gx, gy)), full), plain)
            runs[", expanded dout"] = (ws.grid_vjp(grid, wide, gx, gy, full),
                                       ws.grid_vjp_reference(grid, wide.contiguous(), gx, gy, full))
        torch.cuda.synchronize()
        nan = int(plain.isnan().any(-1).sum())
        scale = max(float(plain.nan_to_num().abs().max()), 1.0)
        for suffix, (out, want) in runs.items():
            err = compare(f"grid_vjp {label}{suffix}", [out], [want])
            log(f"grid_vjp vs plain, {label}{suffix}: max|diff| = {err:.3e} "
                f"(scale {scale:.3e}, {nan} NaN pixels)")
            check(err <= 1e-6 * scale, f"grid_vjp {label}{suffix}: max|diff| {err} "
                  f"> 1e-6 * {scale}")
            max_err = max(max_err, err)
        if label.startswith("nan") and "shard" not in label:
            check(nan >= 1, f"grid_vjp {label}: no NaN where the coordinate is NaN")

    # phase 3: the inputs the main path gives it, from K1 on the timing sets
    sets = []
    for im, gr, nchw, do, do_nchw in timing_sets(torch, rng, dev, B, H, W, C):
        _, gx, gy = ws.warp_sample_grads(im, gr)
        sets.append((gr, do, gx, gy, nchw, do_nchw))
    fns = {"kernel": lambda gr, do, gx, gy, *_: ws.grid_vjp(gr, do, gx, gy, H),
           "plain": lambda gr, do, gx, gy, *_: ws.grid_vjp_reference(gr, do, gx, gy, H),
           "library": lambda gr, _, __, ___, nchw, do_nchw:
               torch.ops.aten.grid_sampler_2d_backward(
                   do_nchw, nchw, gr, 0, 1, True, [False, True])[1]}
    device_ms = {k: graph_ms(fn, sets) for k, fn in fns.items()}
    npx = B * H * W
    # grid, dout, gx, gy read once, dgrid written once; 2C products, 2(C-1)
    # sums and ~12 for the two slopes and products
    bound_ms, bound_by = bound(npx * (8 + 3 * 4 * C + 8), npx * (4 * C + 12))
    log(json.dumps({"warp_sample_bwd_grid_us": device_ms["kernel"] * 1e3,
                    "bound_us": bound_ms * 1e3, "plain_ms": device_ms["plain"],
                    "library_ms": device_ms["library"],
                    "library": "torch.ops.aten.grid_sampler_2d_backward(bilinear, "
                               "border, align_corners, output_mask [False, True]), "
                               "NCHW: the grid gradient alone, re-gathering the taps",
                    "timing": "device, CUDA graph of 40 calls x 10 replays",
                    "shape": f"{B}x{H}x{W}x{C} f32", "card": card}))
    return {"name": "warp_sample_bwd_grid", "route": "cuda",
            "source": "monodepth_tpu_torch/csrc/warp_sample.cu",
            "replaces": "monodepth_tpu/ops/pallas/warp_sample.py:340 (_grid_vjp, jnp)",
            "launches": None, "max_abs_err": max_err, "ms": device_ms["kernel"],
            "plain_ms": device_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": device_ms["library"],
            "library": "torch.ops.aten.grid_sampler_2d_backward, grid gradient only"}


def phase_grads_kernel(torch, dev, ws, cfg, card):
    """Phases 2 and 3 for the train-form warp kernel (K1) and the
    gradient of `WarpSample`. Returns its `kernels` entry."""
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    B, H, W, C = cfg.batch, cfg.height, cfg.width, 3
    img = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(dev)
    max_err = 0.0
    for name, field in warp_fields(rng, B, H, W).items():
        grid = torch.from_numpy(field).to(dev)
        ours = ws.warp_sample_grads(img, grid)
        plain = ws.warp_sample_grads_reference(img, grid)
        torch.cuda.synchronize()
        err = compare(f"warp_sample_grads {name}", ours, plain,
                      1 if name == "nan" else None)
        log(f"warp_sample_grads (out, gx, gy) vs plain, {name} {B}x{H}x{W}x{C}: "
            f"max|diff| = {err:.3e}")
        check(err <= 1e-6, f"warp_sample_grads {name}: max|diff| {err} > 1e-6")
        max_err = max(max_err, err)
        if name == "nan":
            continue
        dgrids = []
        for plain_fwd in (False, True):
            g = grid.clone().requires_grad_(True)
            ws.WarpSample.apply(img, g, plain_fwd).backward(dout)
            dgrids.append(g.grad)
        scale = max(float(dgrids[1].abs().max()), 1.0)
        derr = float((dgrids[0] - dgrids[1]).abs().max())
        log(f"WarpSample dgrid, kernel vs plain forward, {name}: max|diff| = "
            f"{derr:.3e} (scale {scale:.3e})")
        check(derr <= 1e-6 * scale, f"WarpSample dgrid {name}: {derr} > 1e-6 * {scale}")
    oi = torch.from_numpy(rng.uniform(size=(3, 7, 33, 4)).astype(np.float32)).to(dev)
    og = torch.from_numpy(warp_fields(rng, 3, 7, 33)["wild"]).to(dev)
    err = compare("warp_sample_grads odd", ws.warp_sample_grads(oi, og),
                  ws.warp_sample_grads_reference(oi, og))
    log(f"warp_sample_grads vs plain, odd 3x7x33x4: max|diff| = {err:.3e}")
    check(err <= 1e-6, f"warp_sample_grads odd shape: max|diff| {err} > 1e-6")
    max_err = max(max_err, err, pixel_group_cases(torch, dev, ws, rng))

    # phase 3
    sets = timing_sets(torch, rng, dev, B, H, W, C)

    def pair_kernel(im, gr, _, do, __):
        g = gr.detach().requires_grad_(True)
        return torch.autograd.grad(ws.WarpSample.apply(im, g), g, do)[0]

    def pair_library(_, gr, nchw, __, do_nchw):
        g = gr.detach().requires_grad_(True)
        out = F.grid_sample(nchw, g, mode="bilinear", padding_mode="border",
                            align_corners=True)
        return torch.autograd.grad(out, g, do_nchw)[0]

    fns = {"kernel": lambda im, gr, *_: ws.warp_sample_grads(im, gr),
           "plain": lambda im, gr, *_: ws.warp_sample_grads_reference(im, gr),
           "pair": pair_kernel, "pair_library": pair_library}
    device_ms = {k: graph_ms(fn, sets) for k, fn in fns.items()}
    eager_ms = {k: cuda_ms(fn, sets, 40 if k == "plain" else 200)
                for k, fn in fns.items()}
    npx = B * H * W
    # forward: grid + image + out, gx, gy; backward: dout, gx, gy, grid in,
    # dgrid out (each read or written once)
    bound_ms, bound_by = bound(npx * (8 + 4 * C + 3 * 4 * C), npx * (10 + 13 * C))
    bwd_ms, _ = bound(npx * (3 * 4 * C + 8 + 8), npx * (4 * C + 12))
    log(json.dumps({"warp_sample_fwd_grads_us": device_ms["kernel"] * 1e3,
                    "bound_us": bound_ms * 1e3, "plain_ms": device_ms["plain"],
                    "WarpSample_fwd_bwd_us": device_ms["pair"] * 1e3,
                    "fwd_bwd_bound_us": (bound_ms + bwd_ms) * 1e3,
                    "library_fwd_bwd_us": device_ms["pair_library"] * 1e3,
                    "library": "F.grid_sample(border, align_corners=True), NCHW, "
                               "forward + backward with respect to the grid",
                    "timing": "device, CUDA graph of 40 calls x 10 replays",
                    "eager_ms": eager_ms,
                    "eager_timing": "CUDA events around eager calls (host launch cost included)",
                    "shape": f"{B}x{H}x{W}x{C} f32", "card": card}))
    return {"name": "warp_sample_fwd_grads", "route": "cuda",
            "source": "monodepth_tpu_torch/csrc/warp_sample.cu",
            "replaces": "monodepth_tpu/ops/pallas/warp_sample.py:109",
            "launches": None, "max_abs_err": max_err, "ms": device_ms["kernel"],
            "plain_ms": device_ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call returns out, gx and gy; the yardstick of
            # the forward + backward pair is in the fields below
            "library_ms": None,
            "fwd_bwd_ms": device_ms["pair"], "fwd_bwd_bound_ms": bound_ms + bwd_ms,
            "fwd_bwd_library_ms": device_ms["pair_library"]}


PROBES = {  # kernel -> (probe, the Pallas kernel it replaces)
    "take_along_axis": ("P-A", "tools/pallas_probe.py:35"),
    "row_gather": ("P-B", "tools/pallas_probe.py:70"),
    "row_sum": ("P-C", "tools/pallas_probe.py:89"),
    "slab_gather": ("P-D", "tools/pallas_probe.py:115"),
}


def probe_cases(rng):
    """{kernel: [(label, numpy inputs, extra args)]}: the probe tool's
    inputs, the CPU tests' shapes with out-of-range indices, one odd shape."""
    import numpy as np

    from monodepth_tpu_torch.ops.cuda import probes
    from monodepth_tpu_torch.tools import kernel_probe as kp

    def gather(S, W, lo, hi):
        return (rng.uniform(-1, 1, (S, W)).astype(np.float32),
                rng.integers(lo, hi, (S, W)).astype(np.int32))

    def slab(B, H, W):
        return (rng.uniform(-1, 1, (B, H, W)).astype(np.float32),
                rng.integers(-W // 8, W + W // 8, (B, H, W)).astype(np.int32))

    def slab_extremes():
        """Rows of negative indices, of indices at and past W, the int32
        extremes; the rest in range."""
        src, idx = slab(2, 16, 256)
        idx[0, 0], idx[0, 1], idx[0, 2] = -1 - idx[0, 0] % 256, 256 + idx[0, 1] % 256, 256
        idx[1, 3, ::2], idx[1, 3, 1::2] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
        return src, idx

    src64 = rng.uniform(-1, 1, (64, 256)).astype(np.float32)
    return {
        "take_along_axis": [("probe 8x128", kp.inputs_a(), ()),
                            ("test 8x128", gather(8, 128, -300, 300), ()),
                            ("odd 3x200", gather(3, 200, -450, 450), ())],
        "row_gather": [("probe 8x640", kp.inputs_b(640), ())]
        + [(f"test 8x{W}", gather(8, W, -W // 2, W + W // 2), ()) for W in (128, 256, 640)]
        + [("odd 5x384", gather(5, 384, -200, 600), ())],
        "row_sum": [("probe 192x640 lim (50, 61)", kp.inputs_c(), ())]
        + [(f"test 64x256 lim {lim}", (src64, np.array(lim, np.int32)), ())
           for lim in ((50, 61), (0, 64), (7, 7), (9, 3))]
        + [("odd 97x640 lim (0, 97)", (rng.uniform(-1, 1, (97, 640)).astype(np.float32),
                                       np.array([0, 97], np.int32)), ())],
        "slab_gather": [(f"probe 12x192x640 n_y={n}", kp.inputs_d(), (n,)) for n in range(1, 9)]
        + [(f"test 2x16x256 n_y={n}", slab(2, 16, 256), (n,)) for n in (1, 4, 8)]
        + [(f"odd 1x8x128 n_y={n}", slab(1, 8, 128), (n,)) for n in (1, 4, 8)]
        + [("extreme indices 2x16x256 n_y=8", slab_extremes(), (8,))]
        + [(f"widest rows 1x8x{probes.slab_max_width(n)} n_y={n}",
            slab(1, 8, probes.slab_max_width(n)), (n,)) for n in (1, 4, 8)],
    }


def distinct(torch, keys) -> int:
    return int(torch.unique(keys).numel())


def phase_probes(torch, dev, card):
    """Phase 4 for the four probe kernels. Returns their `kernels` entries."""
    import numpy as np

    from monodepth_tpu_torch.ops.cuda import probes
    from monodepth_tpu_torch.tools import kernel_probe as kp

    rng = np.random.default_rng(4)
    errs = {}
    for name, cases in probe_cases(rng).items():
        kernel, plain = getattr(probes, name), getattr(probes, f"{name}_reference")
        err = 0.0
        for label, arrays, extra in cases:
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            ours = kernel(*args, *extra)
            torch.cuda.synchronize()
            e = compare(f"{name} {label}", [ours], [plain(*args, *extra)])
            log(f"{name} vs plain, {label}: max|diff| = {e:.3e}, "
                f"{int(ours.isnan().sum())} NaN")
            check(e == 0, f"{name} {label}: max|diff| {e} against the plain version")
            err = max(err, e)
        errs[name] = err

    # phase 3's timing at the tool's shapes; the library calls take the
    # in-range inputs as they are (gather wants int64 indices, made here)
    tab, ia = (torch.from_numpy(a).to(dev) for a in kp.inputs_a())
    row, ib = (torch.from_numpy(a).to(dev) for a in kp.inputs_b(640))
    src, lim = (torch.from_numpy(a).to(dev) for a in kp.inputs_c())
    lo, hi = (int(v) for v in kp.inputs_c()[1])
    B, H, W, n_y = 12, 192, 640, 4

    def slab(s, i):
        return probes.slab_gather(s, i, n_y)

    d_sets = []  # 6 x 11.8 MB, larger than L2
    for _ in range(6):
        d_sets.append(tuple(torch.from_numpy(a).to(dev) for a in (
            rng.uniform(0, 1, (B, H, W)).astype(np.float32),
            rng.integers(0, W, (B, H, W)).astype(np.int32))))
    setups = {
        "take_along_axis": ([(tab, ia, ia.long())], (probes.take_along_axis,
                            probes.take_along_axis_reference),
                            lambda t, _, i64: torch.gather(t, 1, i64),
                            "torch.gather(tab, 1, idx int64)"),
        "row_gather": ([(row, ib, ib.long())], (probes.row_gather,
                       probes.row_gather_reference),
                       lambda r, _, i64: torch.gather(r, 1, i64),
                       "torch.gather(row, 1, idx int64)"),
        "row_sum": ([(src, lim)], (probes.row_sum, probes.row_sum_reference),
                    lambda s, _: s[lo:hi].sum(0),
                    "src[ymin:ymax].sum(0), bounds on the host"),
        "slab_gather": (d_sets, (slab, lambda s, i: probes.slab_gather_reference(s, i, n_y)),
                        None, "none: no single PyTorch call computes it"),
    }
    # least bytes: indices read and outputs written once, and each table
    # element that this run's indices reach (in range) read once
    n_a, n_b = ia.numel(), ib.numel()
    in_d = (d_sets[0][1] >= 0) & (d_sets[0][1] < W)
    slab_of = torch.arange(B * H, device=dev).reshape(B, H, 1) // 8
    bounds = {
        "take_along_axis": bound(8 * n_a + 4 * distinct(
            torch, torch.arange(8, device=dev)[:, None] * 128 + ia), 0),
        "row_gather": bound(8 * n_b + 4 * distinct(
            torch, torch.arange(8, device=dev)[:, None] * 640 + ib), 0),
        "row_sum": bound(8 + 4 * 640 + 4 * 640 * (hi - lo), 640 * (hi - lo)),
        "slab_gather": bound(8 * B * H * W + 4 * n_y * distinct(
            torch, (slab_of * W + d_sets[0][1])[in_d]), n_y * B * H * W),
    }
    # P-D's cost shape: the same kernel on coalesced indices (idx = l), and
    # on one input set, which stays in L2 from call to call
    coalesced = [(s, torch.arange(W, dtype=torch.int32, device=dev).repeat(B, H, 1))
                 for s, _ in d_sets]
    d_extra = {"coalesced_idx_ms": graph_ms(slab, coalesced),
               "l2_warm_ms": graph_ms(slab, d_sets[:1])}
    # the launch floor: a one-element in-place add by the same replay
    one = torch.zeros(1, device=dev)
    floor_us = graph_ms(lambda t: t.add_(1), [(one,)]) * 1e3
    log(json.dumps({"launch_floor_us": floor_us,
                    "what": "one-element in-place add, CUDA graph of 40 calls x 10 replays",
                    "card": card}))
    out = []
    for name, (sets, (kernel, plain), library, library_what) in setups.items():
        extra = d_extra if name == "slab_gather" else {}
        ms = graph_ms(lambda *a: kernel(*a[:2]), sets)
        # the plain P-C reads its bounds on the host: no graph, eager time
        plain_ms = (cuda_ms(lambda *a: plain(*a[:2]), sets, 40) if name == "row_sum"
                    else graph_ms(lambda *a: plain(*a[:2]), sets))
        library_ms = graph_ms(library, sets) if library else None
        eager_ms = cuda_ms(lambda *a: kernel(*a[:2]), sets, 400)
        bound_ms, bound_by = bounds[name]
        probe, replaces = PROBES[name]
        log(json.dumps({f"{name}_us": ms * 1e3, "bound_us": bound_ms * 1e3,
                        "pct_of_bound": 100 * bound_ms / ms,
                        "pct_of_bound_or_floor": 100 * max(bound_ms * 1e3, floor_us)
                        / (ms * 1e3),
                        "launch_floor_us": floor_us,
                        "plain_ms": plain_ms, "library_ms": library_ms,
                        "library": library_what,
                        "timing": "device, CUDA graph of 40 calls x 10 replays"
                                  + ("; plain: eager CUDA events" if name == "row_sum" else ""),
                        "eager_ms": eager_ms,
                        "eager_timing": "CUDA events around eager calls (host launch cost included)",
                        "shape": f"{probe} at the probe tool's shape", **extra,
                        "card": card}))
        out.append({"name": name, "route": "cuda",
                    "source": "monodepth_tpu_torch/csrc/probes.cu",
                    "replaces": replaces, "launches": None,
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms, **extra})
    return out


def phase_probe_path(torch, card) -> dict:
    """Phase 4, the probe tool's path: `kernel_probe.main()` on the card.
    Returns each probe kernel's launches in it."""
    import math

    from monodepth_tpu_torch.ops.cuda import probes
    from monodepth_tpu_torch.tools import kernel_probe as kp

    for name in PROBES:
        getattr(probes, name).launches = 0
    results = kp.main([])
    torch.cuda.synchronize()
    launches = {name: getattr(probes, name).launches for name in PROBES}
    expected = {"take_along_axis": 1, "row_gather": 1, "row_sum": 1, "slab_gather": 52}
    check(launches == expected, f"probe tool launches {launches}, expected {expected}")
    for key, name, arrays in (("A", "take_along_axis", kp.inputs_a()),
                              ("B", "row_gather", kp.inputs_b()),
                              ("C", "row_sum", kp.inputs_c())):
        check(results[key].ok, f"probe {key} printed WRONG")
        plain = getattr(probes, f"{name}_reference")(*map(torch.from_numpy, arrays))
        err = compare(f"probe {key} on the card", [results[key].out.cpu()], [plain])
        check(err == 0, f"probe {key} on the card: max|diff| {err} against the plain version")
    d = results["D"]
    check(d.ok and math.isfinite(d.ms) and d.ms > 0, f"probe D time {d.ms}")
    check(tuple(d.out.shape) == (12, 192, 640) and bool(d.out.isfinite().all()),
          "probe D output not finite or of the wrong shape")
    log(json.dumps({"path": "kernel_probe.main() on the card",
                    "D_ms_per_channel": d.ms,
                    "timing": "CUDA events around 50 dependent calls (each with its "
                              "index add, abs and mean), after 2 warm-up calls",
                    "launches": launches, "card": card}))
    return launches


def phase_train(torch, ws, cfg, model, state, batches, card):
    """Phase 5a. Returns the launches of K1 and K1-bwd in the 3 train
    steps, the step's host ms and its device-busy ms."""
    import numpy as np

    from monodepth_tpu_torch.training.state import MODULES, module_grads
    from monodepth_tpu_torch.training.step import make_train_step

    train_step = make_train_step(model, cfg)
    before = [p.detach().clone() for p in model.parameters()]
    ws.warp_sample.launches = 0
    ws.warp_sample_grads.launches = 0
    ws.grid_vjp.launches = 0
    metrics = [train_step(state, b) for b in batches]
    torch.cuda.synchronize()
    k1, k2 = ws.warp_sample_grads.launches, ws.warp_sample.launches
    bwd = ws.grid_vjp.launches
    check(k1 == 24, f"warp_sample_grads launched {k1} times in 3 train steps, "
          "expected 24 (8 per step)")
    check(bwd == 24, f"grid_vjp launched {bwd} times in 3 train steps, "
          "expected 24 (8 per step)")
    check(k2 == 0, f"warp_sample launched {k2} times in 3 train steps, expected 0")
    losses = [float(m["loss"]) for m in metrics]
    check(all(np.isfinite(losses)), f"non-finite train loss {losses}")
    check({"loss", "warp_span"} == set(metrics[0]), f"metric keys {sorted(metrics[0])}")
    changed = sum(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
    check(changed == len(before), f"{len(before) - changed} of {len(before)} "
          "parameter tensors unchanged by 3 train steps")
    log(f"train losses {losses}, warp_span {[float(m['warp_span']) for m in metrics]}, "
        f"{changed} of {len(before)} parameter tensors changed, "
        f"warp_sample_grads launches {k1}, grid_vjp launches {bwd}, "
        f"warp_sample launches {k2}")

    # the next step twice from the same state: kernel warp, plain warp
    # (forward and backward)
    torch.backends.cudnn.deterministic = True
    try:
        twin = copy.deepcopy(state)
        plain_step = make_train_step(
            twin.model, cfg, sampler=lambda im, gr: ws.WarpSample.apply(im, gr, True))
        loss_k = float(train_step(state, batches[0])["loss"])
        loss_p = float(plain_step(twin, batches[0])["loss"])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    rel = abs(loss_k - loss_p) / abs(loss_p)
    gk, gp = module_grads(model), module_grads(twin.model)
    grad_rel = {m: float((gk[m] - gp[m]).norm() / gp[m].norm()) for m in MODULES}
    log(f"train loss, kernel {loss_k!r} vs plain warp {loss_p!r}: rel {rel:.3e}; "
        f"grad rel-L2 by module {grad_rel}")
    check(rel <= 1e-5, f"kernel vs plain train loss rel {rel} > 1e-5")
    check(all(v <= 1e-3 for v in grad_rel.values()),
          f"kernel vs plain grad rel-L2 {grad_rel} > 1e-3")
    del twin, plain_step

    step_ms = host_ms(torch, lambda i: train_step(state, batches[i % 3]))
    log(json.dumps({"main_path": "train, ResNet-18 separate 640x192 b12 bf16",
                    "train_step_ms": step_ms,
                    "timing": "host clock around synchronize, median of 10",
                    "card": card}))
    profile = profile_steps(
        torch, lambda i: train_step(state, batches[i % 3]),
        {"k1": "warp_sample_fwd_grads_kernel", "k1_bwd": "warp_sample_bwd_grid_kernel"},
        ("train_step/forward", "train_step/backward", "train_step/optimizer",
         "WarpSampleBackward"))
    log(json.dumps({"train_step_profile": profile, "card": card}))
    return ({"warp_sample_fwd_grads": k1, "warp_sample_bwd_grid": bwd}, step_ms,
            profile["device_busy_ms_per_step"])


def phase_eval(torch, ws, cfg, model, state, batches, card):
    """Phase 5b, on the model the train steps left in train mode. Returns
    K2's launches in the 3 eval steps and 3 infer batches."""
    import numpy as np

    from monodepth_tpu_torch.training.step import make_eval_step, make_infer_step

    B = cfg.batch
    eval_step = make_eval_step(model, cfg)
    infer = make_infer_step(model, cfg)
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}

    ws.warp_sample.launches = 0
    ws.warp_sample_grads.launches = 0
    metrics = [eval_step(state, b, i) for i, b in enumerate(batches)]
    depths = [infer(b["frames"][:, 0].astype(np.float32) / 255.0) for b in batches]
    torch.cuda.synchronize()
    launches, k1 = ws.warp_sample.launches, ws.warp_sample_grads.launches

    check(launches == 24, f"warp_sample launched {launches} times in 3 eval "
          "steps + 3 infer batches, expected 24 (8 per eval step)")
    check(k1 == 0, f"warp_sample_grads launched {k1} times in eval, expected 0")
    check(all(torch.equal(v, stats[k]) for k, v in model.state_dict().items()
              if k in stats), "eval or infer changed the running statistics")
    losses = [float(m["loss"]) for m in metrics]
    check(all(np.isfinite(losses)), f"non-finite eval loss {losses}")
    check({"loss", "warp_span"} <= set(metrics[0]), f"metric keys {sorted(metrics[0])}")
    for d in depths:
        check(tuple(d.shape) == (B, cfg.height, cfg.width), f"infer shape {tuple(d.shape)}")
        check(bool(torch.isfinite(d).all()), "non-finite inferred disparity")
        check(float(d.min()) >= 1 / 80.0 - 1e-6 and float(d.max()) <= 1e3 + 1e-3,
              "inferred disparity outside [1/80, 1/1e-3]")
    log(f"eval losses {losses}, warp_span {[float(m['warp_span']) for m in metrics]}, "
        f"warp_sample launches {launches}, running statistics unchanged")

    # the same step with the plain warp, same noise (same seed, step, index)
    plain_step = make_eval_step(model, cfg, sampler=ws.warp_sample_reference)
    plain_loss = float(plain_step(state, batches[0], 0)["loss"])
    rel = abs(plain_loss - losses[0]) / abs(plain_loss)
    log(f"eval loss, kernel {losses[0]!r} vs plain warp {plain_loss!r}: rel {rel:.3e}")
    check(rel <= 1e-5, f"kernel vs plain eval loss rel {rel} > 1e-5")

    images = [b["frames"][:, 0].astype(np.float32) / 255.0 for b in batches]
    eval_ms = host_ms(torch, lambda i: eval_step(state, batches[i % 3], i))
    infer_ms = host_ms(torch, lambda i: infer(images[i % 3]))
    log(json.dumps({"main_path": "eval+infer, ResNet-18 separate 640x192 b12 bf16",
                    "eval_step_ms": eval_ms, "infer_ms": infer_ms,
                    "timing": "host clock around synchronize, median of 10",
                    "card": card}))
    log(json.dumps({"eval_step_profile": profile_steps(
        torch, lambda i: eval_step(state, batches[i % 3], i),
        {"k2": "warp_sample_fwd_kernel"}), "card": card}))
    return launches


SHIFTED = {"warp_sample_fwd_shifted": "warp_sample_shifted",
           "warp_sample_fwd_grads_shifted": "warp_sample_grads_shifted"}


def spatial_slab(image, s: int, n: int, halo: int):
    """Shard s of n's slab of `image` [B, H, W, C] as the halo exchange
    delivers it: its rows with `halo` rows of each neighbour, zeros beyond
    the image -> (own rows, rows from the previous, from the next, row0)."""
    H = image.shape[1]
    Hl = H // n
    own = image[:, s * Hl:(s + 1) * Hl]
    zeros = image.new_zeros((image.shape[0], halo) + tuple(image.shape[2:]))
    prev = image[:, s * Hl - halo:s * Hl] if s > 0 else zeros
    nxt = image[:, (s + 1) * Hl:(s + 1) * Hl + halo] if s < n - 1 else zeros
    return own.contiguous(), prev.contiguous(), nxt.contiguous(), s * Hl - halo


def _slab_cases(torch, dev, cfg, rng):
    """[(label, slab, grid rows, row0, full height)] at the {spatial: n}
    headline slabs, every shard, smooth, wild and NaN fields."""
    import numpy as np

    B, H, W, C = cfg.batch, cfg.height, cfg.width, 3
    img = torch.from_numpy(rng.uniform(size=(B, H, W, C)).astype(np.float32)).to(dev)
    cases = []
    for name, field in warp_fields(rng, B, H, W).items():
        grid = torch.from_numpy(field).to(dev)
        for n in (2, 4):
            Hl = H // n
            halo = min(cfg.spatial_halo, Hl)
            for s in range(n):
                own, prev, nxt, row0 = spatial_slab(img, s, n, halo)
                slab = torch.cat([prev, own, nxt], 1)
                rows = grid[:, s * Hl:(s + 1) * Hl].contiguous()
                cases.append((f"{name} n={n} s={s} slab {tuple(slab.shape)}",
                              slab, rows, row0, H))
    return cases


def touched_bytes(torch, slab, grid, row0: int, full_height: int) -> int:
    """Bytes of the slab pixels that the taps of `grid` reach (each read
    once): what this run's data needs of the slab."""
    B, Himg, W, C = slab.shape
    x = torch.clamp((grid[..., 0] + 1.0) * 0.5 * (W - 1), 0.0, W - 1)
    y = torch.clamp((grid[..., 1] + 1.0) * 0.5 * (full_height - 1), 0.0,
                    full_height - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 2).long()
    y0 = torch.clamp(torch.clamp(torch.floor(y), 0, full_height - 2).long() - row0,
                     0, Himg - 2)
    b = torch.arange(B, device=slab.device).reshape(B, 1, 1)
    taps = torch.cat([((b * Himg + y0 + dy) * W + x0 + dx).flatten()
                      for dy in (0, 1) for dx in (0, 1)])
    return int(torch.unique(taps).numel()) * C * 4


def phase_shifted_kernels(torch, dev, ws, cfg, card, entries):
    """Phases 6a and 6c for both forms of K3. Returns their `kernels`
    entries (launches filled in by phase 6b)."""
    import numpy as np
    import torch.nn.functional as F

    rng = np.random.default_rng(6)
    errs = {"warp_sample_fwd_shifted": 0.0, "warp_sample_fwd_grads_shifted": 0.0}
    odd_slab = torch.from_numpy(rng.uniform(size=(3, 11, 33, 4)).astype(np.float32)).to(dev)
    odd_grid = torch.from_numpy(warp_fields(rng, 3, 5, 33)["wild"]).to(dev)
    cases = _slab_cases(torch, dev, cfg, rng) + [
        ("odd slab 3x11x33x4, grid 3x5x33, row0 7 of 23", odd_slab, odd_grid, 7, 23)]
    for label, slab, rows, row0, full in cases:
        nan = 1 if label.startswith("nan") and bool(rows.isnan().any()) else None
        out = ws.warp_sample_shifted(slab, rows, row0, full)
        grads = ws.warp_sample_grads_shifted(slab, rows, row0, full)
        torch.cuda.synchronize()
        e1 = compare(f"warp_sample_shifted {label}", [out],
                     [ws.warp_sample_shifted_reference(slab, rows, row0, full)], nan)
        e2 = compare(f"warp_sample_grads_shifted {label}", grads,
                     ws.warp_sample_grads_shifted_reference(slab, rows, row0, full), nan)
        log(f"K3 vs plain, {label}: eval form max|diff| = {e1:.3e}, "
            f"train form (out, gx, gy) {e2:.3e}")
        check(max(e1, e2) <= 1e-6, f"K3 {label}: max|diff| {max(e1, e2)} > 1e-6")
        check(torch.equal(out.nan_to_num(), grads[0].nan_to_num()),
              f"K3 {label}: the two forms' outputs differ")
        errs["warp_sample_fwd_shifted"] = max(errs["warp_sample_fwd_shifted"], e1)
        errs["warp_sample_fwd_grads_shifted"] = max(errs["warp_sample_fwd_grads_shifted"], e2)

    # phase 6c: the {spatial: 2} shard s=1 (rows 96-191, 224-row slab from
    # row 32) on the smooth field, 4 input sets larger than L2
    B, H, W, C = cfg.batch, cfg.height, cfg.width, 3
    n, s = 2, 1
    Hl, halo = H // n, min(cfg.spatial_halo, H // n)
    sets = []
    for im, gr, *_ in timing_sets(torch, rng, dev, B, H, W, C):
        own, prev, nxt, row0 = spatial_slab(im, s, n, halo)
        slab = torch.cat([prev, own, nxt], 1)
        rows = gr[:, s * Hl:(s + 1) * Hl].contiguous()
        # the same warp for F.grid_sample: y renormalized to the slab's rows
        y = ((rows[..., 1] + 1) * 0.5 * (H - 1) - row0) / (slab.shape[1] - 1) * 2 - 1
        sets.append((slab, rows, slab.permute(0, 3, 1, 2).contiguous(),
                     torch.stack([rows[..., 0], y], -1)))
    fns = {
        "warp_sample_fwd_shifted": (
            lambda sl, gr, *_: ws.warp_sample_shifted(sl, gr, row0, H),
            lambda sl, gr, *_: ws.warp_sample_shifted_reference(sl, gr, row0, H)),
        "warp_sample_fwd_grads_shifted": (
            lambda sl, gr, *_: ws.warp_sample_grads_shifted(sl, gr, row0, H),
            lambda sl, gr, *_: ws.warp_sample_grads_shifted_reference(sl, gr, row0, H)),
    }
    slab_ms = graph_ms(lambda _, __, nchw, g: F.grid_sample(
        nchw, g, mode="bilinear", padding_mode="border", align_corners=True), sets)
    npx = B * Hl * W
    read = touched_bytes(torch, sets[0][0], sets[0][1], row0, H)
    whole = {k: e for k, e in ((e["name"], e) for e in entries)}
    out = []
    for name, (kernel, plain) in fns.items():
        grads = name == "warp_sample_fwd_grads_shifted"
        ms, plain_ms = graph_ms(kernel, sets), graph_ms(plain, sets)
        writes = npx * 4 * C * (3 if grads else 1)
        bound_ms, bound_by = bound(npx * 8 + writes + read,
                                   npx * (10 + (13 if grads else 9) * C))
        slab_bound_ms, _ = bound(npx * 8 + writes + sets[0][0].numel() * 4, 0)
        twin = "warp_sample_fwd_grads" if grads else "warp_sample_fwd"
        log(json.dumps({f"{name}_us": ms * 1e3, "bound_us": bound_ms * 1e3,
                        "bound_whole_slab_us": slab_bound_ms * 1e3,
                        "slab_bytes_touched": read, "plain_ms": plain_ms,
                        f"{twin}_whole_image_us": whole[twin]["ms"] * 1e3,
                        "grid_sample_on_slab_us": slab_ms * 1e3,
                        "grid_sample_on_slab": "F.grid_sample(border, align_corners="
                                               "True) on the NCHW slab, grid renormalized "
                                               "to its rows: the same warp, other inputs",
                        "timing": "device, CUDA graph of 40 calls x 10 replays",
                        "shape": f"{{spatial: 2}} shard 1: slab {B}x{Hl + 2 * halo}x{W}x{C}, "
                                 f"grid {B}x{Hl}x{W}x2, row0 {row0} f32", "card": card}))
        out.append({"name": name, "route": "cuda",
                    "source": "monodepth_tpu_torch/csrc/warp_sample.cu",
                    "replaces": "monodepth_tpu/ops/pallas/warp_sample.py:"
                                + ("389" if grads else "366"),
                    "launches": None, "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    # the eval form's warp is one F.grid_sample on the NCHW slab
                    # with the grid renormalized to the slab's rows; no single
                    # call returns the train form's (out, gx, gy)
                    "library_ms": None if grads else slab_ms,
                    "library": None if grads else "F.grid_sample on the NCHW slab, "
                                                  "grid renormalized to its rows"})
    return out


def phase_spatial_path(torch, ws, cfg, state, batch, card) -> dict:
    """Phase 6b. Returns each K3 form's launches in it."""
    from monodepth_tpu_torch.training.step import local_warp, make_train_step, slab_holds_taps

    seen = []

    def recorder(src, grid):
        seen.append((src, grid.detach()))
        return ws.WarpSample.apply(src, grid)

    twin = copy.deepcopy(state)
    make_train_step(twin.model, cfg, sampler=recorder)(twin, batch)
    del twin
    check(len(seen) == 8, f"recorded {len(seen)} warps in a train step, expected 8")
    H = cfg.height
    dout_gen = torch.Generator(device=seen[0][0].device).manual_seed(6)
    for name in SHIFTED.values():
        getattr(ws, name).launches = 0
    ws.grid_vjp.launches = 0
    worst, checked = 0.0, 0
    for i, (src, grid) in enumerate(seen):
        dout = torch.randn(src.shape, generator=dout_gen, device=src.device)
        g = grid.clone().requires_grad_(True)
        whole = ws.WarpSample.apply(src, g)
        whole.backward(dout)
        whole = whole.detach()
        whole_eval = ws.warp_sample(src, grid)
        scale = max(float(g.grad.abs().max()), 1.0)
        for n in (2, 4):
            Hl, halo = H // n, min(cfg.spatial_halo, H // n)
            outs, evals, dgrids = [], [], []
            for s in range(n):
                own, prev, nxt, row0 = spatial_slab(src, s, n, halo)
                rows = grid[:, s * Hl:(s + 1) * Hl].contiguous()
                check(bool(slab_holds_taps(rows, row0, Hl + 2 * halo, H)),
                      f"warp {i} n={n} shard {s}: a tap leaves the slab")
                r = rows.clone().requires_grad_(True)
                out = local_warp(own, prev, nxt, r, s, H, True)
                out.backward(dout[:, s * Hl:(s + 1) * Hl])
                outs.append(out.detach())
                dgrids.append(r.grad)
                evals.append(local_warp(own, prev, nxt, rows, s, H, False))
            err = max(float((torch.cat(outs, 1) - whole).abs().max()),
                      float((torch.cat(evals, 1) - whole_eval).abs().max()))
            derr = float((torch.cat(dgrids, 1) - g.grad).abs().max())
            check(err == 0, f"warp {i} n={n}: stitched K3 vs whole-image K1/K2 "
                  f"max|diff| {err}")
            check(derr <= 1e-6 * scale, f"warp {i} n={n}: dgrid {derr} > 1e-6 * {scale}")
            worst = max(worst, derr / scale)
            checked += 1
    torch.cuda.synchronize()
    launches = {k: getattr(ws, name).launches for k, name in SHIFTED.items()}
    bwd = ws.grid_vjp.launches
    check(launches == {k: 48 for k in SHIFTED},
          f"K3 launches {launches} in the one-card spatial path, expected 48 of each")
    check(bwd == 56, f"grid_vjp launched {bwd} times in the one-card spatial path, "
          "expected 56 (48 shards' WarpSampleShifted + 8 whole-image WarpSample)")
    log(json.dumps({"path": "one-card spatial path: local_warp of every rank, "
                            "n in {2, 4}, the 8 warps of a 640x192 b12 train step",
                    "warps_x_meshes": checked, "stitched_vs_whole_max_abs": 0.0,
                    "dgrid_max_rel_to_scale": worst, "launches": launches,
                    "grid_vjp_launches": bwd, "card": card}))
    return launches


def _run_steps(name: str, data: int, spatial: int, precision: str):
    """`parallel.run_steps` over NCCL with --reference at the headline
    config in `precision` -> (each rank's report, rank 0's first-step
    gradients of the mesh and of one card by module), launches checked."""
    import torch

    out = os.path.join(HERE, "build", "run_steps", f"{name}_{precision}")
    cmd = [sys.executable, "-m", "monodepth_tpu_torch.parallel.run_steps",
           "--data", str(data), "--spatial", str(spatial), "--device", "cuda",
           "--spawn", "--reference", "--save-grads", "--steps", "2", "--timeout",
           "300", "--deadline", "540", "--out", out, "--precision", precision]
    done = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": HERE})
    check(done.returncode == 0, f"run_steps {name} {precision} failed:\n"
          f"{done.stderr[-4000:]}")
    reports = [json.load(open(os.path.join(out, f"rank{r}.json")))
               for r in range(data * spatial)]
    for r in reports:
        # 8 warps in each of 2 train steps and the eval step: each on a
        # slab (one K3 launch) or in the fallback; K1 and K2 never
        n = r["launches"]
        k3 = n["warp_sample_fwd_grads_shifted"] + n["warp_sample_fwd_shifted"]
        # each train-form slab warp's backward is one K1-bwd launch: 16 in
        # the 2 train steps when none falls back
        check(k3 == r["slab_warps"] > 0 and k3 + r["fallbacks"] == 24
              and n["warp_sample_fwd"] == n["warp_sample_fwd_grads"] == 0
              and n["warp_sample_bwd_grid"] == n["warp_sample_fwd_grads_shifted"],
              f"{name} {precision} rank {r['rank']}: launches {n}, slab warps "
              f"{r['slab_warps']}, fallbacks {r['fallbacks']}")
        check(r["losses"] == reports[0]["losses"], f"{name}: ranks' losses differ")
    return reports, torch.load(os.path.join(out, "grads.pt"))


def _rel_l2(a: dict, b: dict) -> dict:
    """{module: |a - b| / |b|} over flattened gradients."""
    return {m: float((a[m].double() - b[m].double()).norm() / b[m].double().norm())
            for m in b}


def phase_multi_gpu(torch, card):
    """Phase 7: `run_steps` over NCCL, one card per rank, when the cards
    are there. Each mesh runs in f32 (TF32 off: only summation order
    separates it from one card, loss rtol 1e-5) and in bf16, the headline
    precision, held to the one card's own bf16-vs-f32 gap of this run:
    the loss at rtol max(1e-4, that gap), the first-step gradients of
    each module at rel-L2 max(1e-3, that module's gap). The split batch
    rounds its bf16 convolutions elsewhere, and bf16 keeps ~3 digits.
    Returns the K3 launches of rank 0 of the largest mesh in bf16 and
    what they were counted on, or None when fewer than 2 cards show."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f"phase 7 (multi-GPU steps over NCCL) NOT RUN: {count} CUDA device "
            "visible; NCCL puts one rank on each card, so the collectives need 2 "
            "or more. They are proven with gloo on the CPU (tests/test_torch_parallel*.py).")
        return None
    meshes = [("spatial2", 1, 2)] + ([("data2_spatial2", 2, 2)] if count >= 4 else [])
    for name, data, spatial in meshes:
        t = time.perf_counter()
        runs, grads = {}, {}
        for p in ("f32", "bf16"):
            runs[p], grads[p] = _run_steps(name, data, spatial, p)
        ref = {p: r[0]["reference"] for p, r in runs.items()}
        floor = max(abs(a - b) / abs(b) for a, b in zip(ref["bf16"]["losses"],
                                                        ref["f32"]["losses"]))
        tol = {"f32": 1e-5, "bf16": max(1e-4, floor)}
        # the precision's own gradient error on one card, and where the
        # mesh's bf16 gradients lie against the f32 ones
        one, mesh = ({p: grads[p][k] for p in grads} for k in ("one_device", "mesh"))
        grad_gap = _rel_l2(one["bf16"], one["f32"])
        grad_tol = {m: max(1e-3, v) for m, v in grad_gap.items()}
        log(json.dumps({"path": f"run_steps over NCCL, {name}, 640x192 b12",
                        "seconds": time.perf_counter() - t,
                        "one_card_bf16_vs_f32_loss_rel": floor, "loss_rtol": tol,
                        "one_card_bf16_vs_f32_grad_rel_l2": grad_gap,
                        "mesh_bf16_vs_f32_grad_rel_l2": _rel_l2(mesh["bf16"], mesh["f32"]),
                        "mesh_bf16_vs_one_card_f32_grad_rel_l2":
                            _rel_l2(mesh["bf16"], one["f32"]),
                        "bf16_grad_rel_l2_limit": grad_tol,
                        **{p: {"ranks": [{k: r[k] for k in (
                            "rank", "device_name", "losses", "eval", "launches",
                            "slab_warps", "fallbacks", "seconds")} for r in runs[p]],
                            "one_card": {k: ref[p][k] for k in (
                                "losses", "loss_rel", "grad_rel_l2", "param_max_abs",
                                "eval_rel")}} for p in runs},
                        "card": card}))
        for p in runs:
            check(max(ref[p]["loss_rel"]) <= tol[p],
                  f"{name} {p}: losses {runs[p][0]['losses']} vs one card "
                  f"{ref[p]['losses']}: rel {ref[p]['loss_rel']} > {tol[p]}")
        over = {m: v for m, v in ref["bf16"]["grad_rel_l2"].items() if v > grad_tol[m]}
        check(not over, f"{name} bf16: gradient rel-L2 vs one card {over} above the "
              f"one card's own bf16-vs-f32 gap {grad_tol}")
    launches = runs["bf16"][0]["launches"]
    return ({k: launches[k] for k in SHIFTED},
            f"phase 7: run_steps over NCCL, {name} bf16, rank 0 (2 train steps "
            "and 1 eval step)")


def phase_main_path(torch, ws, card):
    """Phase 5: train, then eval and infer, on one model. Returns the
    launches of each kernel on its path, and the train step's host ms and
    device-busy ms."""
    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.data.synthetic import make_planar_scenes
    from monodepth_tpu_torch.training.state import build_model, create_state

    cfg = Config().validate()
    B = cfg.batch
    t0 = time.perf_counter()
    scenes = make_planar_scenes(3 * B, cfg.height, cfg.width, seed=0)
    batches = [{k: scenes[k][i * B:(i + 1) * B]
                for k in ("frames", "jitter", "K", "inv_K")} for i in range(3)]
    model = build_model(cfg)  # on the card, seeded from cfg.seed
    state = create_state(cfg, model, steps_per_epoch=100)
    log(f"main path setup: {time.perf_counter() - t0:.1f} s "
        f"(scenes + model, {sum(p.numel() for p in model.parameters())} params)")
    launches, step_ms, busy_ms = phase_train(torch, ws, cfg, model, state, batches, card)
    launches["warp_sample_fwd"] = phase_eval(torch, ws, cfg, model, state, batches, card)
    launches.update(phase_spatial_path(torch, ws, cfg, state, batches[0], card))
    return launches, step_ms, busy_ms


PHASE8 = os.path.join(HERE, "build", "phase8")
EVAL_LINES, EVAL_BATCH = 46, 16


def kitti_tree():
    """Phase 8a: a synthetic KITTI tree at KITTI's native image size
    (375x1242, 26 frames, both cameras) and its split files: 48 lines with
    both neighbours (train), the first 46 of them as the test list, so
    that --eval_batch 16 ends in a ragged batch of 14. -> (datapath,
    splits dir, test lines, train lines)."""
    import shutil

    from monodepth_tpu_torch.data import kitti
    from monodepth_tpu_torch.data.synthetic import DRIVE, make_kitti_tree

    shutil.rmtree(PHASE8, ignore_errors=True)
    t = time.perf_counter()
    root = make_kitti_tree(os.path.join(PHASE8, "kitti"), num_frames=26, seed=0,
                           image_hw=(375, 1242))
    lines = [f"{DRIVE} {i} {side}" for i in range(1, 25) for side in "lr"]
    splits = os.path.join(PHASE8, "splits")
    os.makedirs(os.path.join(splits, "kitti_eigen_zhou"))
    kitti.savelines(lines[:EVAL_LINES],
                    os.path.join(splits, "kitti_eigen_zhou", "test_files.txt"))
    kitti.savelines(lines, os.path.join(splits, "kitti_eigen_zhou", "train_files.txt"))
    log(f"phase 8a: KITTI tree, 26 frames x 2 cameras at 375x1242, "
        f"{EVAL_LINES} test and {len(lines)} train lines: {time.perf_counter() - t:.1f} s")
    return root, splits, lines[:EVAL_LINES], lines


def phase_eigen_cli(torch, root, splits, lines, card) -> dict:
    """Phase 8b: the seeded headline model's encoder and decoder written as
    official-layout `encoder.pth` and `depth.pth`, converted by the port's
    `convert_torch_weights monodepth2`, evaluated by `python -m
    monodepth_tpu_torch.model_test` (a subprocess, on the card) with
    --save_pred_disps. The saved disparities against `make_infer_step` on
    the same decoded frames in the same batches (max |diff| <= 1e-3 · max
    |disp|: the processes may pick other cuDNN algorithms), the printed
    table against `eigen_metrics` of those disparities. -> its numbers."""
    import numpy as np

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.evaluation import eigen
    from monodepth_tpu_torch.training.state import build_model
    from monodepth_tpu_torch.training.step import make_infer_step

    cfg = Config(datapath=root, splits=splits, weight_init=False)
    model = build_model(cfg)  # on the card, seeded from cfg.seed
    pth, weights = os.path.join(PHASE8, "pth"), os.path.join(PHASE8, "weights")
    os.makedirs(pth)
    torch.save({**{f"encoder.{k}": v.cpu() for k, v in model.encoder.state_dict().items()},
                "height": cfg.height, "width": cfg.width}, os.path.join(pth, "encoder.pth"))
    torch.save({k: v.cpu() for k, v in model.decoder.state_dict().items()},
               os.path.join(pth, "depth.pth"))

    def run(*args):
        return subprocess.run([sys.executable, "-m", *args], cwd=HERE, capture_output=True,
                              text=True, timeout=600, env={**os.environ, "PYTHONPATH": HERE})

    done = run("monodepth_tpu_torch.tools.convert_torch_weights", "monodepth2", pth,
               weights, "--epoch", "0")
    check(done.returncode == 0, f"convert_torch_weights failed:\n{done.stderr[-3000:]}")
    check(sorted(os.listdir(weights)) == ["decoder0.npz", "encoder0.npz"],
          f"convert_torch_weights wrote {sorted(os.listdir(weights))}")
    out = os.path.join(PHASE8, "disps.npy")
    t = time.perf_counter()
    done = run("monodepth_tpu_torch.model_test", "--datapath", root, "--splits", splits,
               "--eval_batch", str(EVAL_BATCH), "--weights", f"{weights}:0",
               "--save_pred_disps", out, "--gt_cache", os.path.join(PHASE8, "gt_cache"))
    cli_s = time.perf_counter() - t
    check(done.returncode == 0, f"model_test failed:\n{done.stderr[-3000:]}")
    log(done.stdout.strip())
    printed = done.stdout.rstrip("\n").splitlines()  # the row ends in spaces
    disps = np.load(out)
    check(disps.shape == (EVAL_LINES, cfg.height, cfg.width) and bool(np.isfinite(disps).all()),
          f"saved disparities {disps.shape}, finite {bool(np.isfinite(disps).all())}")

    # the same weights in this process, the same batches, the direct infer step
    loaded = eigen.state_from_modules(cfg, weights, 0)
    want = model.state_dict()
    for key, value in loaded.state_dict().items():
        if key.split(".")[0] in ("encoder", "decoder") and "num_batches" not in key:
            check(torch.equal(value, want[key]), f"converted weight {key} differs")
    infer = make_infer_step(loaded, cfg)
    batches = list(eigen.eval_batches(cfg, lines, EVAL_BATCH))
    sizes = [len(b) for b in batches]
    check(sizes == [16, 16, 14], f"eval batches {sizes}, expected [16, 16, 14]")
    direct = np.concatenate([infer(b).float().cpu().numpy() for b in batches])
    diff, scale = float(np.abs(direct - disps).max()), float(np.abs(direct).max())
    log(f"model_test disparities vs make_infer_step on the same batches: max|diff| "
        f"{diff:.3e} (max |disp| {scale:.3e})")
    check(diff <= 1e-3 * scale, f"CLI vs direct infer: max|diff| {diff} > 1e-3 * {scale}")

    t = time.perf_counter()
    gts = eigen.load_ground_truth(root, lines)
    gt_ms = (time.perf_counter() - t) * 1e3 / len(lines)
    metrics = eigen.eigen_metrics(disps, gts)
    row = ">>>" + ("   {:4.3f}  " * 7).format(*metrics.values())
    check(all(np.isfinite(list(metrics.values()))), f"non-finite metrics {metrics}")
    check(printed[-3:] == [f">>> {weights}:0", printed[-2], row]
          and "abs_rel" in printed[-2] and printed[0] == f">>> Testset length {EVAL_LINES}",
          f"printed table {printed[-3:]} differs from eigen_metrics {row!r}")

    # the sweep in this process: predict_disparities (loader, infer, host copy)
    def sweep(_):
        eigen.predict_disparities(cfg, loaded, lines, EVAL_BATCH, infer=infer)

    sweep(0)  # warm: loader threads, cuDNN for the ragged batch
    sweep_ms = host_ms(torch, sweep, n=3)
    return {"cli_seconds": cli_s, "cli_vs_direct_max_abs": diff, "max_abs_disp": scale,
            "metrics": metrics, "gt_projection_ms_per_image": gt_ms,
            "eigen_sweep_images_per_s": len(lines) / sweep_ms * 1e3,
            "eigen_sweep_ms": sweep_ms}


def phase_loader_path(torch, ws, root, lines, card):
    """Phase 8c: `KittiDataset` (training, with GT) batches of 12 through
    `Loader` and `prefetch_to_device` into 2 train steps and 2 eval steps
    on a fresh seeded headline model, each path with the launch counts set
    to 0 just before it and read just after; every batch on the card equal
    to the host batch of the same epoch. -> (cfg, state, a card batch,
    launches)."""
    import numpy as np

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.data.dataset import KittiDataset
    from monodepth_tpu_torch.data.pipeline import Loader, prefetch_to_device
    from monodepth_tpu_torch.training.state import build_model, create_state
    from monodepth_tpu_torch.training.step import make_eval_step, make_train_step

    cfg = Config(datapath=root).validate()
    dataset = KittiDataset(root, lines, is_training=True, frame_ids=cfg.frame_ids,
                           height=cfg.height, width=cfg.width, load_depth=True)
    loader = Loader(dataset, cfg.batch, shuffle=True, num_workers=8, seed=cfg.seed,
                    process_index=0, process_count=1)
    model = build_model(cfg)
    state = create_state(cfg, model, steps_per_epoch=len(loader))
    train_step, eval_step = make_train_step(model, cfg), make_eval_step(model, cfg)
    try:
        host = list(loader.epoch(0))
        check(len(host) == 4, f"{len(host)} batches of 12 from {len(lines)} lines")
        arriving = prefetch_to_device(loader.epoch(0), size=2)

        def arrive(i):
            batch = next(arriving)
            for key, value in batch.items():
                check(value.is_cuda and torch.equal(value.cpu(), torch.from_numpy(host[i][key])),
                      f"batch {i} {key}: the card's copy differs from the host array")
            return batch

        ws.warp_sample.launches = 0
        ws.warp_sample_grads.launches = 0
        ws.grid_vjp.launches = 0
        train = [train_step(state, arrive(i)) for i in range(2)]
        torch.cuda.synchronize()
        k1, bwd, k2 = (ws.warp_sample_grads.launches, ws.grid_vjp.launches,
                       ws.warp_sample.launches)
        check((k1, bwd, k2) == (16, 16, 0), f"2 train steps on loader batches launched K1 "
              f"{k1}, K1-bwd {bwd}, K2 {k2} times; expected 16, 16, 0")
        losses = [float(m["loss"]) for m in train]
        check(all(np.isfinite(losses)), f"non-finite train loss {losses}")

        ws.warp_sample.launches = 0
        ws.warp_sample_grads.launches = 0
        batches = [arrive(2), arrive(3)]
        evals = [eval_step(state, b, i) for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        k2, k1_eval = ws.warp_sample.launches, ws.warp_sample_grads.launches
        check((k2, k1_eval) == (16, 0), f"2 eval steps on loader batches launched K2 {k2}, "
              f"K1 {k1_eval} times; expected 16, 0")
        check(next(arriving, None) is None, "prefetch_to_device yielded more than 4 batches")
    finally:
        loader.close()
    depth = {k: float(v) for k, v in evals[0].items() if k not in ("loss", "warp_span")}
    check(len(depth) == 7 and all(np.isfinite(list(depth.values()))),
          f"eval depth metrics {depth}")
    plain = make_eval_step(model, cfg, sampler=ws.warp_sample_reference)(state, batches[0], 0)
    loss, plain_loss = float(evals[0]["loss"]), float(plain["loss"])
    rel = abs(loss - plain_loss) / abs(plain_loss)
    check(rel <= 1e-5, f"loader eval step, kernel vs plain warp loss rel {rel} > 1e-5")
    log(json.dumps({"path": "KITTI loader -> prefetch_to_device -> train and eval steps, "
                            "640x192 b12 bf16", "train_losses": losses,
                    "eval_losses": [float(m["loss"]) for m in evals], "eval_depth": depth,
                    "eval_kernel_vs_plain_loss_rel": rel,
                    "launches": {"warp_sample_fwd_grads": k1, "warp_sample_bwd_grid": bwd,
                                 "warp_sample_fwd": k2},
                    "card": card}))
    return cfg, state, batches[0], {"warp_sample_fwd_grads": k1,
                                    "warp_sample_bwd_grid": bwd, "warp_sample_fwd": k2}


def phase_remat(torch, ws, cfg, state, batch, card) -> dict:
    """Phase 8d: one train step with --remat from a deep copy of the state
    against one without, on one loader batch (cuDNN deterministic for the
    pair): loss rtol 1e-5, per-module gradient rel-L2 <= 1e-3, running
    statistics equal and counted once, K1 16 times with remat and 8
    without, K1-bwd 8 each; the peak memory of each step."""
    import dataclasses

    from monodepth_tpu_torch.training.state import MODULES, module_grads
    from monodepth_tpu_torch.training.step import make_train_step

    twin = copy.deepcopy(state)
    for encoder in (twin.model.encoder, twin.model.pose_encoder):
        encoder.remat = True
    tracked = {k: int(v) for k, v in state.model.named_buffers() if "num_batches" in k}
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, c, s in (("plain", cfg, state),
                           ("remat", dataclasses.replace(cfg, remat=True), twin)):
            step = make_train_step(s.model, c)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ws.warp_sample_grads.launches = 0
            ws.grid_vjp.launches = 0
            loss = float(step(s, batch)["loss"])
            torch.cuda.synchronize()
            runs[name] = {"loss": loss, "k1": ws.warp_sample_grads.launches,
                          "k1_bwd": ws.grid_vjp.launches,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "step_peak_above_start_bytes": torch.cuda.max_memory_allocated() - base}
    finally:
        torch.backends.cudnn.deterministic = False
    rel = abs(runs["remat"]["loss"] - runs["plain"]["loss"]) / abs(runs["plain"]["loss"])
    gp, gr = module_grads(state.model), module_grads(twin.model)
    grad_rel = {m: float((gr[m] - gp[m]).norm() / gp[m].norm()) for m in MODULES}
    log(json.dumps({"path": "--remat train step vs without, one loader batch, 640x192 b12 bf16",
                    "loss_rel": rel, "grad_rel_l2": grad_rel, **runs, "card": card}))
    check((runs["plain"]["k1"], runs["remat"]["k1"]) == (8, 16),
          f"K1 launches {runs['plain']['k1']} without remat, {runs['remat']['k1']} with; "
          "expected 8 and 16")
    check(runs["plain"]["k1_bwd"] == runs["remat"]["k1_bwd"] == 8, "K1-bwd launches not 8")
    check(rel <= 1e-5, f"remat vs plain train loss rel {rel} > 1e-5")
    check(all(v <= 1e-3 for v in grad_rel.values()), f"remat grad rel-L2 {grad_rel} > 1e-3")
    ours, theirs = dict(twin.model.named_buffers()), dict(state.model.named_buffers())
    for key, value in theirs.items():
        check(torch.equal(ours[key], value), f"remat step: buffer {key} differs")
    for key, n in tracked.items():
        runs_ = 1 if key.startswith("encoder.") else len(cfg.source_frame_ids)
        check(int(theirs[key]) == n + runs_, f"{key}: {n} -> {int(theirs[key])}, "
              f"expected +{runs_} (one update per batch it saw)")
    return runs


def loader_rates(torch, root, lines) -> dict:
    """Phase 8e: `Loader` batches/s at 640x192 b12 over the training
    dataset (3 frames, GT), native decoder and PIL: 3 epochs of 4 batches
    after a warm-up epoch, 8 threads."""
    from monodepth_tpu_torch import native
    from monodepth_tpu_torch.data.dataset import KittiDataset
    from monodepth_tpu_torch.data.pipeline import Loader

    rates = {}
    for decoder in ("native", "PIL"):
        if decoder == "native" and not native.available():
            rates[decoder] = "not available (no g++ or libjpeg): not measured"
            continue
        dataset = KittiDataset(root, lines, is_training=True, frame_ids=(0, -1, 1),
                               use_native=decoder == "native")
        loader = Loader(dataset, 12, shuffle=True, num_workers=8,
                        process_index=0, process_count=1)
        try:
            list(loader.epoch(0))
            t = time.perf_counter()
            n = sum(1 for e in range(1, 4) for _ in loader.epoch(e))
            rates[decoder] = n / (time.perf_counter() - t)
        finally:
            loader.close()
    return rates


def phase_kitti(torch, ws, card):
    """Phase 8, on one card at the headline config. Returns the launches
    of K1, K1-bwd and K2 on the loader path (8c), the tree (datapath,
    splits dir, test lines, train lines) and the loader rates (8e)."""
    from monodepth_tpu_torch import native

    decoder = "native (C++ libjpeg + Lanczos)" if native.available() else "PIL"
    log(f"phase 8: the dataset decodes with {decoder}")
    root, splits, test_lines, train_lines = kitti_tree()
    cli = phase_eigen_cli(torch, root, splits, test_lines, card)
    cfg, state, batch, launches = phase_loader_path(torch, ws, root, train_lines, card)
    remat = phase_remat(torch, ws, cfg, state, batch, card)
    rates = loader_rates(torch, root, train_lines)
    log(json.dumps({"phase": "8e, KITTI host path and Eigen CLI, 640x192",
                    "decoder": decoder, "loader_batches_per_s_b12": rates,
                    "loader_timing": "host clock, 3 epochs of 4 batches after a warm-up "
                                     "epoch, 8 threads, training samples (3 frames + GT)",
                    **cli,
                    "eigen_timing": "host clock, predict_disparities over 46 images "
                                    "(eval_batch 16), median of 3 after one warm sweep",
                    "remat_peak_bytes": remat["remat"]["peak_bytes"],
                    "plain_peak_bytes": remat["plain"]["peak_bytes"],
                    "remat_step_peak_above_start_bytes":
                        remat["remat"]["step_peak_above_start_bytes"],
                    "plain_step_peak_above_start_bytes":
                        remat["plain"]["step_peak_above_start_bytes"],
                    "card": card}))
    return launches, (root, splits, test_lines, train_lines), rates


PHASE9 = os.path.join(HERE, "build", "phase9")
VALID_LINES = 24  # 2 validation steps of 12


def _records(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _untimed(record):
    """A metrics.jsonl record without its wall-clock fields."""
    out = {k: v for k, v in record.items() if k != "time"}
    for split in ("train", "valid"):
        out[split] = {k: v for k, v in record[split].items() if k != "img_per_sec"}
    return out


def state_diff(a, b) -> float:
    """max |a - b| over two TrainStates' parameters, buffers and Adam state
    (inf where a tensor or the step differs in shape, NaN pattern or count)."""
    ta = list(a.model.state_dict().values())
    tb = list(b.model.state_dict().values())
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    if a.step != b.step or len(ta) != len(tb) or oa.keys() != ob.keys():
        return float("inf")
    ta += [oa[i][k] for i in oa for k in sorted(oa[i])]
    tb += [ob[i][k] for i in ob for k in sorted(ob[i])]
    diff = 0.0
    for x, y in zip(ta, tb):
        x, y = x.double(), y.double()
        if x.shape != y.shape or not bool((x.isnan() == y.isnan()).all()):
            return float("inf")
        d = (x - y).nan_to_num(0.0).abs()
        diff = max(diff, float(d.max()) if d.numel() else 0.0)
    return diff


def nondeterministic_ops(torch, trainer) -> list:
    """The warnings of one train step under
    `torch.use_deterministic_algorithms(True, warn_only=True)`: the ops
    with no deterministic form on the card."""
    import warnings

    batch = next(iter(trainer.train_loader.epoch(0)))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        trainer.close()
    return sorted({str(w.message)[:300] for w in caught})


def kernel_wrappers(ws) -> dict:
    """{name in the kernels line: wrapper} for all eight kernels; each
    wrapper counts its launches in `.launches`."""
    from monodepth_tpu_torch.ops.cuda import probes

    out = {"warp_sample_fwd": ws.warp_sample, "warp_sample_fwd_grads": ws.warp_sample_grads,
           "warp_sample_bwd_grid": ws.grid_vjp}
    out.update({name: getattr(ws, fn) for name, fn in SHIFTED.items()})
    out.update({name: getattr(probes, name) for name in PROBES})
    return out


class counted:
    """Counts the calls of module attributes (the plain versions) while
    entered: {"module.name": calls}."""

    def __init__(self, targets):
        self.targets = targets
        self.counts = {}

    def __enter__(self):
        self.saved = []
        for module, name in self.targets:
            fn, key = getattr(module, name), f"{module.__name__}.{name}"
            self.counts[key] = 0

            def wrapper(*args, _fn=fn, _key=key, **kw):
                self.counts[_key] += 1
                return _fn(*args, **kw)

            self.saved.append((module, name, fn))
            setattr(module, name, wrapper)
        return self.counts

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def phase_train_cli(torch, root, splits, card) -> dict:
    """Phase 9a: `python -m monodepth_tpu_torch.model_train` for 2 epochs
    with a checkpoint and an Eigen sweep each, the encoders from a seeded
    torchvision-layout `resnet18.pth`; then `model_test` on its export."""
    import numpy as np

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.training import Trainer
    from monodepth_tpu_torch.training.state import build_model

    pre = os.path.join(PHASE9, "pretrained")
    os.makedirs(pre)
    sd = {k: v.cpu() for k, v in build_model(Config(seed=7)).encoder.state_dict().items()}
    g = torch.Generator().manual_seed(7)
    sd.update({"fc.weight": 0.01 * torch.randn(1000, 512, generator=g),
               "fc.bias": torch.zeros(1000)})
    torch.save(sd, os.path.join(pre, "resnet18.pth"))
    flags = ["--datapath", root, "--splits", splits, "--save_root", PHASE9,
             "--save", "cli", "--epoch", "2", "--ckpt_every", "1", "--eigen_every", "1",
             "--log_every", "2", "--weight_init", "true", "--pretrained_dir", pre,
             "--num_workers", "8"]
    env = {**os.environ, "PYTHONPATH": HERE}
    t = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "monodepth_tpu_torch.model_train", *flags],
                          cwd=HERE, capture_output=True, text=True, timeout=600, env=env)
    cli_s = time.perf_counter() - t
    check(done.returncode == 0, f"model_train failed:\n{done.stderr[-3000:]}")
    log(done.stdout.strip()[-4000:])
    save = os.path.join(PHASE9, "cli")
    records = _records(save)
    check(len(records) == 2, f"{len(records)} metrics.jsonl records, expected 2")
    for r in records:
        losses = [r["train"]["loss"], r["valid"]["loss"]]
        check(all(v is not None and np.isfinite(v) for v in losses),
              f"epoch {r['epoch']}: losses {losses}")
        check("eigen" in r and len(r["eigen"]) == 7
              and all(v is not None and np.isfinite(v) for v in r["eigen"].values()),
              f"epoch {r['epoch']}: eigen block {r.get('eigen')}")
        check(r.get("warp_sampler") == "cuda", f"warp_sampler {r.get('warp_sampler')}")
    files = set(os.listdir(save))
    want = {"state_0000.pt", "state_0001.pt", "metrics.jsonl"} | {
        f"{m}{e}.npz" for e in (1, 2)
        for m in ("encoder", "decoder", "pose_encoder", "pose_decoder")}
    check(want <= files, f"model_train wrote {sorted(files)}; missing {sorted(want - files)}")

    # the encoders came from the .pth: Trainer.__init__ with the same flags
    from monodepth_tpu_torch.config import options

    trainer = Trainer(options(flags))
    try:
        conv1 = sd["conv1.weight"]
        check(torch.equal(trainer.model.encoder.conv1.weight.cpu(), conv1),
              "the encoder's conv1 is not the .pth's")
        check(torch.equal(trainer.model.pose_encoder.conv1.weight.cpu(),
                          torch.cat([conv1] * 2, 1) / 2),
              "the pose encoder's conv1 is not the .pth's, tiled")
    finally:
        trainer.close()

    done = subprocess.run([sys.executable, "-m", "monodepth_tpu_torch.model_test",
                           "--datapath", root, "--splits", splits, "--eval_batch", "12",
                           "--weights", f"{save}:2",
                           "--gt_cache", os.path.join(PHASE9, "gt_cache_eval")],
                          cwd=HERE, capture_output=True, text=True, timeout=600, env=env)
    check(done.returncode == 0, f"model_test failed:\n{done.stderr[-3000:]}")
    printed = [float(v) for v in done.stdout.rstrip().splitlines()[-1].split()[1:]]
    want = list(records[-1]["eigen"].values())
    tol = 1e-3 * max(abs(v) for v in want) + 5e-4  # + half the printed digit
    gap = max(abs(a - b) for a, b in zip(printed, want))
    log(f"model_test on {save}:2 {printed} vs the last in-training sweep {want}: "
        f"max|diff| {gap:.3e} (tolerance {tol:.3e}); {card}")
    check(len(printed) == 7 and gap <= tol, f"model_test table {printed} vs {want}")
    log(json.dumps({"phase": "9a, model_train CLI, 2 epochs at 640x192 b12 bf16",
                    "cli_seconds": cli_s, "model_test_vs_sweep_max_abs": gap,
                    "train_img_per_s": [r["train"]["img_per_sec"] for r in records],
                    "card": card}))
    return records


def phase_trainer(torch, ws, root, splits, train_lines, card, step_ms, loader_rates):
    """Phase 9: the Trainer and the train CLI at the headline config on
    phase 8's tree (48 train lines: 4 steps an epoch; 24 validation
    lines: 2 steps). Returns the launches of K1, K1-bwd and K2 in 9c's
    uninterrupted 2-epoch run."""
    import dataclasses
    import shutil

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.data import kitti
    from monodepth_tpu_torch.training import Trainer
    from monodepth_tpu_torch.training import step as step_module

    t0 = time.perf_counter()
    shutil.rmtree(PHASE9, ignore_errors=True)
    kitti.savelines(train_lines[:VALID_LINES],
                    os.path.join(splits, "kitti_eigen_zhou", "val_files.txt"))
    cli_records = phase_train_cli(torch, root, splits, card)

    # 9b and 9c: 2 epochs against 1 and a resume, in this process
    cfg = Config(datapath=root, splits=splits, save_root=PHASE9, weight_init=False,
                 num_workers=8, log_every=0)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        whole = Trainer(dataclasses.replace(cfg, epoch=2, save="whole"))
        plain = [(ws, "warp_sample_reference"), (ws, "warp_sample_grads_reference"),
                 (ws, "grid_vjp_reference"), (step_module, "grid_sample")]
        wrappers = kernel_wrappers(ws)
        for fn in wrappers.values():
            fn.launches = 0
        with counted(plain) as plain_calls:
            whole.train()
            torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        steps = 2 * len(whole.train_loader)
        valid = 2 * len(whole.valid_loader)
        check((steps, valid) == (8, 4), f"{steps} train and {valid} validation steps")
        # K3 and the probes are not on this path: they must read 0
        expected = {name: 0 for name in wrappers}
        expected.update({"warp_sample_fwd_grads": 8 * steps,
                         "warp_sample_bwd_grid": 8 * steps, "warp_sample_fwd": 8 * valid})
        check(launches == expected, f"Trainer launches {launches}, expected {expected}")
        check(not any(plain_calls.values()), f"plain versions called: {plain_calls}")
        log(json.dumps({"path": "Trainer, 2 epochs of 4 train + 2 validation steps, "
                                "640x192 b12 bf16", "launches": launches,
                        "plain_version_calls": plain_calls, "card": card}))

        first = Trainer(dataclasses.replace(cfg, epoch=1, save="split"))
        first.train()
        resumed = Trainer(dataclasses.replace(cfg, epoch=2, save="split", resume=True))
        check(resumed.start_epoch == 1, f"resumed at epoch {resumed.start_epoch}")
        resumed.train()
        diff = state_diff(whole.state, resumed.state)
        ours, theirs = _records(whole.save_dir), _records(resumed.save_dir)
        same = [_untimed(r) for r in ours] == [_untimed(r) for r in theirs]
        log(f"resume: 2 epochs vs 1 + resume, max|diff| over parameters, buffers and "
            f"Adam state {diff!r}, metrics.jsonl records equal: {same}; {card}")
        if diff != 0 or not same:
            ops = nondeterministic_ops(torch, Trainer(dataclasses.replace(cfg, save="probe")))
            raise SmokeFailure(f"resume is not bit-equal (max|diff| {diff}, records "
                               f"equal {same}); ops without a deterministic form: {ops}")

        # 9d: --steps_per_call 2 against 1 on the first epoch (the first
        # record of "split": the resumed run appended the second)
        multi = Trainer(dataclasses.replace(cfg, epoch=1, save="multi", steps_per_call=2))
        multi.train()
        diff_k = state_diff(first.state, multi.state)
        same_k = [_untimed(r) for r in theirs[:1]] == \
            [_untimed(r) for r in _records(multi.save_dir)]
        log(f"--steps_per_call 2 vs 1: max|diff| {diff_k!r}, records equal: {same_k}; "
            f"{card}")
        check(diff_k == 0 and same_k, "--steps_per_call 2 differs from 1")
        del whole, first, resumed, multi
    finally:
        torch.backends.cudnn.deterministic = False

    # 9d: the rates, with cuDNN as in phase 5a, on epochs of 24 train steps
    # (the 48 train lines 6 times over), so that filling the loader's
    # pipeline is a small share of an epoch: the Trainer's own loader alone
    # over one epoch, then the Trainer's second epoch, with 8 and 4 loader
    # threads, and with --cache_frames (decoded frames read from .npy
    # files: no JPEG decode)
    step_rate = 12 * 1e3 / step_ms
    rates, loader_img = {}, {}
    for name, extra in (("decode", {}), ("decode_4_threads", {"num_workers": 4}),
                        ("cached_frames", {"cache_frames": True})):
        trainer = Trainer(dataclasses.replace(cfg, epoch=2, save=f"rate_{name}", **extra),
                          train_files=train_lines * 6)
        check(len(trainer.train_loader) == 24, f"{len(trainer.train_loader)} steps an epoch")
        if name.startswith("decode"):
            t = time.perf_counter()
            n = sum(1 for _ in trainer.train_loader.epoch(1))
            loader_img[name] = 12 * n / (time.perf_counter() - t)
        trainer.train()
        rates[name] = _records(trainer.save_dir)[-1]["train"]["img_per_sec"]
        del trainer
    log(json.dumps({
        "phase": "9d, rates at 640x192 b12 bf16",
        "trainer_train_img_per_s": rates,
        "trainer_timing": "host clock over the second epoch's 24 train steps, "
                          "Loader -> prefetch_to_device -> train step, ended by "
                          "torch.cuda.synchronize(); cuDNN not deterministic, as phase 5a",
        "loader_alone_img_per_s": loader_img,
        "loader_timing": "host clock over one epoch (24 batches) of the Trainer's own "
                         "train loader (8 or 4 threads), no step",
        "phase5a_step_img_per_s": step_rate,
        "no_overlap_img_per_s": {k: 1 / (1 / step_rate + 1 / v) for k, v in loader_img.items()},
        "phase8e_loader_img_per_s": {k: 12 * v if isinstance(v, float) else v
                                     for k, v in loader_rates.items()},
        "multi_trainer_img_per_s": _records(os.path.join(PHASE9, "multi"))[0]["train"]
                                   ["img_per_sec"],
        "cli_train_img_per_s": [r["train"]["img_per_sec"] for r in cli_records],
        "card": card}))

    # 9e: the mono convergence proof with the kernels
    from monodepth_tpu_torch.tools import convergence_proof

    ws.warp_sample_grads.launches = ws.grid_vjp.launches = 0
    proof = convergence_proof.main(["--mode", "mono", "--use_pallas", "true",
                                    "--tx_sign", "1"])
    k1, bwd = ws.warp_sample_grads.launches, ws.grid_vjp.launches
    log(json.dumps({"phase": "9e, mono convergence proof", "pass": proof["pass"],
                    "spearman_mean": proof["rank_corr_trained_mean"],
                    "spearman_min": proof["rank_corr_trained_min"],
                    "loss_ratio": proof["loss_ratio"], "train_seconds": proof["train_seconds"],
                    "k1_launches": k1, "k1_bwd_launches": bwd, "card": card}))
    check((k1, bwd) == (8 * 600, 8 * 600), f"convergence proof K1 {k1}, K1-bwd {bwd}")
    check(proof["pass"], f"the convergence proof failed its rule: {proof}")

    span_times(torch, ws, card)
    log(f"phase 9: {time.perf_counter() - t0:.1f} s; {card}")
    return launches


def span_times(torch, ws, card) -> dict:
    """Phase 9f: K1's device time (as phase 3) at 640x192 b12 on fields
    whose vertical offsets span about 14, 40 and 60 px (a sine across
    the width) and on +-50 px uniform noise, beside each field's
    `dy_span`."""
    import numpy as np

    rng = np.random.default_rng(3)
    B, H, W, C = 12, 192, 640, 3
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gx = (xs + 6.0 * np.sin(xs / 17.0 + ys / 23.0)) / (W - 1) * 2 - 1
    cases = {f"{span} px": (span / 2) * np.sin(xs / 9.0)[None] for span in (14, 40, 60)}
    cases["+-50 px noise"] = rng.uniform(-50, 50, (B, H, W))
    out = {}
    for name, dy in cases.items():
        sets = []
        for _ in range(4):
            gy = (ys + dy + rng.uniform(-0.5, 0.5, (B, H, W))) / (H - 1) * 2 - 1
            grid = np.stack(np.broadcast_arrays(gx[None], gy), -1).astype(np.float32)
            image = rng.uniform(size=(B, H, W, C)).astype(np.float32)
            sets.append((torch.from_numpy(image).cuda(), torch.from_numpy(grid).cuda()))
        out[name] = {"dy_span": float(ws.dy_span(sets[0][1])),
                     "k1_ms": graph_ms(ws.warp_sample_grads, sets)}
    ratio = out["+-50 px noise"]["k1_ms"] / out["14 px"]["k1_ms"]
    log(json.dumps({"phase": "9f, K1 time against the warp field's dy span, 640x192 b12",
                    "cases": out, "noise_over_14px": ratio,
                    "timing": "CUDA-graph replay, 40 calls x 10, 4 rotating input sets",
                    "card": card}))
    return out


WIRINGS = {  # phase 10a: name -> the Config fields of the wiring
    "shared": {"pose_type": "shared"},
    "posecnn": {"pose_type": "posecnn"},
    "separate, pose_frames all": {"pose_frames": "all"},
    "separate, mono+stereo (0, -1, 1, s)": {"frame_ids": (0, -1, 1, "s")},
}


def wiring_batches(cfg, n: int, seed: int = 0) -> list:
    """`n` batches of `make_planar_scenes` at `cfg`'s shape; with "s", the
    +1 view again as the stereo frame, with its seeded ground-truth
    baseline as `stereo_T` (identity, the scene's `gt_tx` at [0, 3])."""
    import numpy as np

    from monodepth_tpu_torch.data.synthetic import make_planar_scenes

    B = cfg.batch
    scenes = make_planar_scenes(n * B, cfg.height, cfg.width, seed=seed)
    keys = ["frames", "jitter", "K", "inv_K"]
    if "s" in cfg.frame_ids:
        scenes["frames"] = scenes["frames"][:, [0, 1, 2, 2]]
        stereo_T = np.tile(np.eye(4, dtype=np.float32), (n * B, 1, 1))
        stereo_T[:, 0, 3] = scenes["gt_tx"]
        scenes["stereo_T"] = stereo_T
        keys.append("stereo_T")
    return [{k: scenes[k][i * B:(i + 1) * B] for k in keys} for i in range(n)]


def phase_wirings(torch, ws, card, step5a_ms, busy5a_ms) -> dict:
    """Phase 10: the other pose wirings and mono+stereo at the headline
    config (640x192 b12 bf16, ResNet-18, full width and depth, seeded).
    Returns every kernel's launches in 10a's kernel runs (counts set to 0
    just before, read just after; the plain-warp twins launch none)."""
    import numpy as np

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.training import step as step_module
    from monodepth_tpu_torch.training.state import build_model, create_state, module_grads
    from monodepth_tpu_torch.training.step import make_eval_step, make_train_step

    t0 = time.perf_counter()
    wrappers = kernel_wrappers(ws)
    plain = [(ws, "warp_sample_reference"), (ws, "warp_sample_grads_reference"),
             (ws, "grid_vjp_reference"), (step_module, "grid_sample")]
    for fn in wrappers.values():
        fn.launches = 0
    stereo = None
    for name, fields in WIRINGS.items():
        cfg = Config(**fields).validate()
        warps = len(cfg.source_frame_ids) * len(cfg.scales)
        batches = wiring_batches(cfg, 2)
        model = build_model(cfg)
        state = create_state(cfg, model, steps_per_epoch=100)
        train_step = make_train_step(model, cfg)
        eval_step = make_eval_step(model, cfg)
        # 10a: one train step from one state with the kernels and, from a
        # deep copy, with the plain warp (forward and backward)
        torch.backends.cudnn.deterministic = True
        try:
            twin = copy.deepcopy(state)
            plain_step = make_train_step(
                twin.model, cfg, sampler=lambda im, gr: ws.WarpSample.apply(im, gr, True))
            before = {k: fn.launches for k, fn in wrappers.items()}
            with counted(plain) as train_calls:
                loss_k = float(train_step(state, batches[0])["loss"])
                torch.cuda.synchronize()
            train_launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
            loss_p = float(plain_step(twin, batches[0])["loss"])
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        rel = abs(loss_k - loss_p) / abs(loss_p)
        gk, gp = module_grads(model), module_grads(twin.model)
        grad_rel = {m: float((gk[m] - gp[m]).norm() / gp[m].norm()) for m in gk}
        del twin, plain_step
        # one eval step with the kernels, and with the plain warp
        before = {k: fn.launches for k, fn in wrappers.items()}
        with counted(plain) as eval_calls:
            eval_k = float(eval_step(state, batches[1], 0)["loss"])
            torch.cuda.synchronize()
        eval_launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        eval_p = float(make_eval_step(model, cfg, sampler=ws.warp_sample_reference)(
            state, batches[1], 0)["loss"])
        eval_rel = abs(eval_k - eval_p) / abs(eval_p)
        log(json.dumps({"phase": f"10a, {name}, 640x192 b12 bf16", "warps_per_step": warps,
                        "train_loss_kernel": loss_k, "train_loss_plain": loss_p,
                        "train_loss_rel": rel, "grad_rel_l2": grad_rel,
                        "eval_loss_kernel": eval_k, "eval_loss_plain": eval_p,
                        "eval_loss_rel": eval_rel,
                        "train_launches": {k: v for k, v in train_launches.items() if v},
                        "eval_launches": {k: v for k, v in eval_launches.items() if v},
                        "plain_version_calls": {**train_calls, **eval_calls},
                        "card": card}))
        expected = {k: 0 for k in wrappers}
        check(train_launches == dict(expected, warp_sample_fwd_grads=warps,
                                     warp_sample_bwd_grid=warps),
              f"{name}: train step launches {train_launches}, expected {warps} of K1 "
              "and of K1-bwd")
        check(eval_launches == dict(expected, warp_sample_fwd=warps),
              f"{name}: eval step launches {eval_launches}, expected {warps} of K2")
        check(not any(train_calls.values()) and not any(eval_calls.values()),
              f"{name}: plain versions called: {train_calls} {eval_calls}")
        check(np.isfinite([loss_k, eval_k]).all(), f"{name}: non-finite loss")
        check(rel <= 1e-5, f"{name}: kernel vs plain train loss rel {rel} > 1e-5")
        check(all(v <= 1e-3 for v in grad_rel.values()),
              f"{name}: kernel vs plain grad rel-L2 {grad_rel} > 1e-3")
        check(eval_rel <= 1e-5, f"{name}: kernel vs plain eval loss rel {eval_rel} > 1e-5")
        if "s" in cfg.frame_ids:
            stereo = (train_step, state, batches)
        else:
            del model, state, train_step, eval_step
    launches = {k: fn.launches for k, fn in wrappers.items()}

    # 10b: the mono+stereo train step's time beside phase 5a's mono step
    train_step, state, batches = stereo
    stereo_ms = host_ms(torch, lambda i: train_step(state, batches[i % 2]))
    profile = profile_steps(
        torch, lambda i: train_step(state, batches[i % 2]),
        {"k1": "warp_sample_fwd_grads_kernel", "k1_bwd": "warp_sample_bwd_grid_kernel"})
    log(json.dumps({"phase": "10b, mono+stereo train step, ResNet-18 separate "
                             "(0, -1, 1, s) 640x192 b12 bf16",
                    "train_step_ms": stereo_ms, "phase5a_mono_train_step_ms": step5a_ms,
                    "device_busy_ms_per_step": profile["device_busy_ms_per_step"],
                    "phase5a_mono_device_busy_ms_per_step": busy5a_ms,
                    "profile": profile,
                    "timing": "host clock around synchronize, median of 10; busy from "
                              "torch.profiler over 3 steps",
                    "card": card}))
    del stereo, train_step, state, batches

    # 10c: one ResNet-50 train step with the kernels
    cfg = Config(num_layers=50).validate()
    model = build_model(cfg)
    state = create_state(cfg, model, steps_per_epoch=100)
    train_step = make_train_step(model, cfg)
    batches = wiring_batches(cfg, 2, seed=1)
    ws.warp_sample_grads.launches = ws.grid_vjp.launches = 0
    loss = float(train_step(state, batches[0])["loss"])
    k1, bwd = ws.warp_sample_grads.launches, ws.grid_vjp.launches
    r50_ms = host_ms(torch, lambda i: train_step(state, batches[i % 2]), n=5)
    log(json.dumps({"phase": "10c, ResNet-50 separate train step, 640x192 b12 bf16",
                    "loss": loss, "k1_launches": k1, "k1_bwd_launches": bwd,
                    "params": sum(p.numel() for p in model.parameters()),
                    "train_step_ms": r50_ms,
                    "timing": "host clock around synchronize, median of 5",
                    "card": card}))
    check(np.isfinite(loss), f"ResNet-50 train loss {loss}")
    check((k1, bwd) == (8, 8), f"ResNet-50 train step K1 {k1}, K1-bwd {bwd}")
    del model, state, train_step

    # 10d: the stereo convergence proof with the kernels
    from monodepth_tpu_torch.tools import convergence_proof

    ws.warp_sample_grads.launches = ws.grid_vjp.launches = 0
    proof = convergence_proof.main(["--mode", "stereo", "--use_pallas", "true"])
    k1, bwd = ws.warp_sample_grads.launches, ws.grid_vjp.launches
    log(json.dumps({"phase": "10d, stereo convergence proof", "pass": proof["pass"],
                    "spearman_mean": proof["rank_corr_trained_mean"],
                    "spearman_min": proof["rank_corr_trained_min"],
                    "spearman_untrained_mean": proof["rank_corr_untrained_mean"],
                    "loss_ratio": proof["loss_ratio"], "train_seconds": proof["train_seconds"],
                    "k1_launches": k1, "k1_bwd_launches": bwd, "card": card}))
    check((k1, bwd) == (4 * 600, 4 * 600), f"stereo proof K1 {k1}, K1-bwd {bwd}")
    check(proof["pass"], f"the stereo convergence proof failed its rule: {proof}")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s; {card}")
    return launches


def _device_total(event) -> float:
    """Device µs of the kernels launched under a CPU-side event."""
    for name in ("device_time_total", "cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_steps(torch, step, kernels: dict, ranges=(), n: int = 3) -> dict:
    """Device time of `n` warmed calls of step(i), from torch.profiler: in
    all, by kernel name (`kernels`: label -> name substring), in the
    autograd nodes, and under each CPU-side range or op in `ranges`;
    device numbers are None if the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile

    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    events = prof.key_averages()
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    # a record_function range (and the optimizer's) also shows on the device
    # timeline as an annotation spanning its kernels: leave those out
    ranges_seen = {e.key for e in host}
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key not in ranges_seen]
    if not device:
        return {"steps": n, "wall_ms_per_step_profiled": wall_ms,
                "device_busy_ms_per_step": None, "device_idle_share": None}
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / n
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:12]
    out = {"steps": n, "wall_ms_per_step_profiled": wall_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "kernels_per_step": sum(e.count for e in device) / n}
    for label, name in kernels.items():
        hits = [e for e in device if name in e.key]
        out[f"{label}_device_ms_per_step"] = \
            sum(e.self_device_time_total for e in hits) / 1e3 / n
        out[f"{label}_launches_per_step"] = sum(e.count for e in hits) / n
    # the backward runs on autograd's device thread, outside any range the
    # caller opened: its device time is that of all the autograd nodes
    out["device_ms_per_step in autograd nodes"] = sum(
        _device_total(e) for e in host
        if e.key.startswith("autograd::engine::evaluate_function:")) / 1e3 / n
    for name in ranges:
        # an autograd node shows twice (the node and the engine's wrapper
        # around it); both hold the same kernels, so take the larger
        totals = [_device_total(e) for e in host if e.key.endswith(name)]
        out[f"device_ms_per_step under {name}"] = max(totals, default=0.0) / 1e3 / n
    out["top"] = [[e.key[:90], e.self_device_time_total / 1e3 / n, e.count / n]
                  for e in top]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from monodepth_tpu_torch.ops.cuda import warp_sample as ws
    from monodepth_tpu_torch.ops.cuda.build import build_libraries
    from monodepth_tpu_torch.config import Config

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t = time.perf_counter()
    for name, output in build_libraries(["warp_sample", "probes"]).items():
        log(f"nvcc {name}:\n{output.strip()}")
    log(f"kernel build: {time.perf_counter() - t:.1f} s")

    dev = torch.device("cuda")
    entries = [phase_kernels(torch, dev, ws, Config(), card),
               phase_grads_kernel(torch, dev, ws, Config(), card),
               phase_grid_vjp_kernel(torch, dev, ws, Config(), card),
               *phase_probes(torch, dev, card)]
    entries += phase_shifted_kernels(torch, dev, ws, Config(), card, entries)
    launches = phase_probe_path(torch, card)
    main_launches, step_ms, busy_ms = phase_main_path(torch, ws, card)
    launches.update(main_launches)
    k3_on = ("phase 6b: the one-card per-rank emulation of the spatial path "
             "(every rank of {spatial: 2} and {spatial: 4}, 8 warps)")
    mesh = phase_multi_gpu(torch, card)
    if mesh is not None:
        k3, k3_on = mesh
        launches.update(k3)
    loader_launches, (root, splits, _, train_lines), rates = phase_kitti(torch, ws, card)
    trainer_launches = phase_trainer(torch, ws, root, splits, train_lines, card, step_ms,
                                     rates)
    wirings_launches = phase_wirings(torch, ws, card, step_ms, busy_ms)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        if entry["name"] in SHIFTED:
            entry["launches_on"] = k3_on
        if entry["name"] in loader_launches:
            entry["launches_loader_path"] = loader_launches[entry["name"]]
        entry["launches_trainer_path"] = trainer_launches[entry["name"]]
        entry["launches_wirings_path"] = wirings_launches[entry["name"]]

    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
