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
   equal exactly, NaN exactly where the plain version has NaN; each
   kernel's device time as in phase 3 (rotating inputs larger than L2 for
   P-D), beside its bound from this run's inputs, its plain version's time
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
8. the `kernels` JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
   K3's launches there are those of phase 7's largest mesh in bf16 (rank
   0) when phase 7 ran, else phase 6b's one-card per-rank emulation;
   "launches_on" says which.
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

    from monodepth_tpu_torch.tools import kernel_probe as kp

    def gather(S, W, lo, hi):
        return (rng.uniform(-1, 1, (S, W)).astype(np.float32),
                rng.integers(lo, hi, (S, W)).astype(np.int32))

    def slab(B, H, W):
        return (rng.uniform(-1, 1, (B, H, W)).astype(np.float32),
                rng.integers(-W // 8, W + W // 8, (B, H, W)).astype(np.int32))

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
        "slab_gather": [("probe 12x192x640 n_y=4", kp.inputs_d(), (4,))]
        + [(f"test 2x16x256 n_y={n}", slab(2, 16, 256), (n,)) for n in (1, 4, 8)]
        + [("odd 1x8x128 n_y=8", slab(1, 8, 128), (8,))],
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
    steps."""
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
    log(json.dumps({"train_step_profile": profile_steps(
        torch, lambda i: train_step(state, batches[i % 3]),
        {"k1": "warp_sample_fwd_grads_kernel", "k1_bwd": "warp_sample_bwd_grid_kernel"},
        ("train_step/forward", "train_step/backward", "train_step/optimizer",
         "WarpSampleBackward")), "card": card}))
    return {"warp_sample_fwd_grads": k1, "warp_sample_bwd_grid": bwd}


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
    launches of each kernel on its path."""
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
    launches = phase_train(torch, ws, cfg, model, state, batches, card)
    launches["warp_sample_fwd"] = phase_eval(torch, ws, cfg, model, state, batches, card)
    launches.update(phase_spatial_path(torch, ws, cfg, state, batches[0], card))
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
    launches.update(phase_main_path(torch, ws, card))
    k3_on = ("phase 6b: the one-card per-rank emulation of the spatial path "
             "(every rank of {spatial: 2} and {spatial: 4}, 8 warps)")
    mesh = phase_multi_gpu(torch, card)
    if mesh is not None:
        k3, k3_on = mesh
        launches.update(k3)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        if entry["name"] in SHIFTED:
            entry["launches_on"] = k3_on

    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
