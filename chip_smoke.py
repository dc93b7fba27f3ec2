#!/usr/bin/env python3
"""Build and run the PyTorch port on one CUDA card, and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a host with one NVIDIA Hopper
card and the CUDA toolkit. It exits non-zero, and prints no result, when
no card is present or when it runs without the repository beside it.
Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi); build every CUDA kernel
   from `monodepth_tpu_torch/csrc/`, one nvcc per source, all at once;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, on smooth, wild and NaN/inf fields and
   one odd shape: max |diff| <= 1e-6, NaN exactly where the plain
   version has NaN. For the train form (K1) also the gradient with
   respect to the grid through `WarpSample`, kernel forward against plain
   forward: max |diff| <= 1e-6 · max(scale, 1);
3. each kernel's device time (CUDA events around replays of a CUDA
   graph of 40 calls, warmed, rotating inputs larger than L2), beside
   its bound, its plain version's time and, where one PyTorch call
   computes the same function, that call's time; for K1 also the forward
   and backward of `WarpSample` beside `F.grid_sample`'s forward and
   backward with respect to the grid. The eager times, host launch cost
   included, are printed beside them;
4. the main path: `build_model(Config())` (ResNet-18, separate pose,
   640x192, batch 12, bf16) from a seeded init on `make_planar_scenes`,
   through the public entry points, each path with the launch counts set
   to 0 just before it and read just after:
   a. train: `create_state(..., steps_per_epoch=100)`, 3 train steps
      (losses finite, every parameter changed, 24 K1 launches, no K2);
      then one step from a deep copy of the model and optimizer with the
      plain warp forward and the same noise (loss rtol 1e-5, per-module
      gradient rel-L2 <= 1e-3, cuDNN deterministic for that pair); the
      step's time and profile;
   b. eval and infer, on the trained model: 3 eval steps and 3 infer
      batches (24 K2 launches, no K1, running statistics unchanged); then
      one eval step again with the plain warp, loss rtol 1e-5;
5. the `kernels` JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
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
MODULES = ("encoder", "decoder", "pose_encoder", "pose_decoder")


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


def grads_by_module(model):
    """{top-level module: its parameters' gradients, flattened, f64}."""
    import torch

    out = {}
    for m in MODULES:
        out[m] = torch.cat([p.grad.double().flatten() for n, p in model.named_parameters()
                            if n.split(".")[0] == m])
    return out


def phase_train(torch, ws, cfg, model, state, batches, card):
    """Phase 4a. Returns K1's launches in the 3 train steps."""
    import numpy as np

    from monodepth_tpu_torch.training.step import make_train_step

    train_step = make_train_step(model, cfg)
    before = [p.detach().clone() for p in model.parameters()]
    ws.warp_sample.launches = 0
    ws.warp_sample_grads.launches = 0
    metrics = [train_step(state, b) for b in batches]
    torch.cuda.synchronize()
    k1, k2 = ws.warp_sample_grads.launches, ws.warp_sample.launches
    check(k1 == 24, f"warp_sample_grads launched {k1} times in 3 train steps, "
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
        f"warp_sample_grads launches {k1}, warp_sample launches {k2}")

    # the next step twice from the same state: kernel warp, plain forward
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
    gk, gp = grads_by_module(model), grads_by_module(twin.model)
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
        {"k1": "warp_sample_fwd_grads_kernel"},
        ("train_step/forward", "train_step/backward", "train_step/optimizer",
         "WarpSampleBackward")), "card": card}))
    return k1


def phase_eval(torch, ws, cfg, model, state, batches, card):
    """Phase 4b, on the model the train steps left in train mode. Returns
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


def phase_main_path(torch, ws, card):
    """Phase 4: train, then eval and infer, on one model. Returns the
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
    return {"warp_sample_fwd_grads": phase_train(torch, ws, cfg, model, state,
                                                 batches, card),
            "warp_sample_fwd": phase_eval(torch, ws, cfg, model, state, batches,
                                          card)}


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
    for name, output in build_libraries(["warp_sample"]).items():
        log(f"nvcc {name}:\n{output.strip()}")
    log(f"kernel build: {time.perf_counter() - t:.1f} s")

    dev = torch.device("cuda")
    entries = [phase_kernels(torch, dev, ws, Config(), card),
               phase_grads_kernel(torch, dev, ws, Config(), card)]
    launches = phase_main_path(torch, ws, card)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]

    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
