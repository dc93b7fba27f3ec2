"""The row primitives of the spatial mesh (`monodepth_tpu_torch.parallel.
rows` and the ops that use it) on this rank's rows of tiny float64 inputs,
one process per rank of a {spatial: 3} mesh on the CPU (gloo), for
tests/test_torch_rows.py. Imports no jax.

    python tests/torch_rows_worker.py OUT_DIR

Each case is a function of its inputs that is the whole-image op outside
`row_sharding` and the row-sharded op inside it, so the test computes the
reference with the same function on the same inputs (`inputs`, `modules`:
numpy and torch seeds). A case's output is row pieces ("rows"), this
rank's part of a sum over the ranks ("part"), or the whole value held by
every rank ("whole"). Each rank's loss is its part of the whole loss: the
output piece times its rows of a seeded cotangent ("rows"), the output
itself ("part"), or the output times a weight of the rank's own ("whole").
Each rank writes OUT_DIR/rank<r>.npz: per case, its outputs and the
gradient of its loss with respect to its rows of each input; and the
synced batch norm of its own f32 and bf16 piece through the module and
through plain autograd ops (`synced_norm`)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from monodepth_tpu_torch.data.augment import color_jitter
from monodepth_tpu_torch.losses.smoothness import smooth_loss
from monodepth_tpu_torch.models.depth_decoder import Conv3x3, DepthDecoder
from monodepth_tpu_torch.models.pose_decoder import PoseCNN
from monodepth_tpu_torch.models.resnet import BatchNorm2d, ResNetEncoder
from monodepth_tpu_torch.ops.sampling import resize_bilinear
from monodepth_tpu_torch.ops.ssim import ssim
from monodepth_tpu_torch.parallel import init_distributed, make_mesh, rows
from monodepth_tpu_torch.parallel.mesh import all_reduce_sum
from monodepth_tpu_torch.parallel.run_steps import spawn

N = 3  # ranks: the middle one has two neighbours
B, H, W = 2, 24, 10  # 8 rows a rank


def modules():
    """The cases' modules, from one torch seed, in float64 and eval mode
    (batch norm from random running statistics)."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        conv = torch.nn.Conv2d
        mods = {"conv7s2": conv(3, 4, 7, 2, 3), "conv3s1": conv(3, 4, 3, 1, 1),
                "conv3s2": conv(3, 4, 3, 2, 1), "conv1s2": conv(3, 4, 1, 2, 0),
                "max_pool": torch.nn.MaxPool2d(3, 2, 1), "reflect_conv": Conv3x3(3, 4),
                "skip_conv": Conv3x3(7, 4),
                "encoder": ResNetEncoder(18), "decoder": None, "posecnn": PoseCNN(2)}
        mods["decoder"] = DepthDecoder(mods["encoder"].num_ch_enc)
        for m in mods["encoder"].modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return {k: m.double().eval() for k, m in mods.items()}


def _depth_net(mods, image):
    disps = mods["decoder"](mods["encoder"](image))
    return [disps[s] for s in sorted(disps)]


def _whole_level(mods, x):
    """The level rule's gather and split: `x`'s rows gathered, a stride-2
    conv and the nearest upsample run whole, then split back beside `x`'s
    rows (the depth decoder's skip concat) into a reflection-padded conv."""
    whole = rows.relevel(x, True, False)
    with rows.level(False):
        y = rows.conv2d(mods["conv3s2"], whole)
    y = rows.relevel(F.interpolate(y, scale_factor=2, mode="nearest"), False, True)
    return mods["skip_conv"](torch.cat([y, x], 1))


# name -> (function of (modules, *inputs), {input: (shape, row axis)}, kind,
# the rows of the level whose plan the case reads, the outputs' row axis)
CASES = {
    **{name: (lambda mods, x, name=name: rows.conv2d(mods[name], x),
              {"x": ((B, 3, H, W), 2)}, "rows", H, 2)
       for name in ("conv7s2", "conv3s1", "conv3s2", "conv1s2")},
    "max_pool": (lambda mods, x: rows.max_pool2d(mods["max_pool"], x),
                 {"x": ((B, 3, H, W), 2)}, "rows", H, 2),
    "reflect_conv": (lambda mods, x: mods["reflect_conv"](x),
                     {"x": ((B, 3, H, W), 2)}, "rows", H, 2),
    **{f"resize_x{f}": (lambda mods, x, f=f: resize_bilinear(x, 6 * f, 5 * f),
                        {"x": ((B, 6, 5, 3), 1)}, "rows", 6, 1) for f in (2, 4, 8)},
    "ssim": (lambda mods, a, b: ssim(a, b),
             {"a": ((B, H, W, 3), 1), "b": ((B, H, W, 3), 1)}, "rows", H, 1),
    "smoothness": (lambda mods, disp, color: smooth_loss(disp, color),
                   {"disp": ((B, H, W, 1), 1), "color": ((B, H, W, 3), 1)}, "part", H, None),
    "contrast_jitter": (lambda mods, img, jitter: color_jitter(img, jitter),
                        {"img": ((B, 2, H, W, 3), 2), "jitter": ((B, 5), None)},
                        "rows", H, 2),
    "spatial_mean": (lambda mods, x: rows.spatial_mean(x, (2, 3)),
                     {"x": ((B, 3, H, W), 2)}, "whole", H, None),
    "loss_mean": (lambda mods, x: rows.loss_mean(x * x),
                  {"x": ((B, 3, H, W), 2)}, "part", H, None),
    # the depth network on rows at 96 rows: 32/16/8/4/2/1 rows a rank
    "depth_net": (_depth_net, {"image": ((B, 3, 96, 32), 2)}, "rows", 96, 2),
    # the level rule: a level that runs whole, split back; PoseCNN at 48
    # rows gathers at its 3-row level (48/24/12/6/3 rows, then 2)
    "level_rule_split": (_whole_level, {"x": ((B, 3, H, W), 2)}, "rows", H, 2),
    "level_rule_posecnn": (lambda mods, x: list(mods["posecnn"](x)),
                           {"x": ((B, 6, 48, 32), 2)}, "whole", 48, None),
}


def inputs(name: str):
    """The case's whole inputs, float64 from a numpy seed (jitter: apply,
    brightness, contrast, saturation, hue), each with its row axis."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    out = {}
    for key, (shape, axis) in CASES[name][1].items():
        if key == "jitter":
            x = np.stack([np.ones(B), rng.uniform(0.8, 1.2, B), rng.uniform(0.8, 1.2, B),
                          rng.uniform(0.8, 1.2, B), rng.uniform(-0.1, 0.1, B)], 1)
        else:
            x = rng.uniform(0.05, 1.0, shape)
        out[key] = (torch.from_numpy(x), axis)
    return out


def as_list(out):
    return out if isinstance(out, list) else [out]


def cotangent(name: str, k: int, shape, rank: int | None = None) -> torch.Tensor:
    """The seeded cotangent of output `k` of a case ("rows": of the whole
    output; "whole": rank `rank`'s weight)."""
    seed = 1000 + 10 * sorted(CASES).index(name) + k + (0 if rank is None else 100 * (rank + 1))
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(shape)))


def piece(t: torch.Tensor, axis, rank: int) -> torch.Tensor:
    if axis is None:
        return t
    size = t.shape[axis] // N
    return t.narrow(axis, rank * size, size).contiguous()


def synced_norm_by_autograd(bn, x):
    """`BatchNorm2d`'s synced normalization as plain autograd ops (the
    training step's output only: no running statistics), the composition
    that `_SyncedNorm` must match bit for bit."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dtype)
    C = x.shape[1]
    count = torch.full((1,), float(x.numel() // C), dtype=dtype, device=x.device)
    stats = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]),
                           bn.process_group)
    mean = stats[:C] / stats[-1]
    var = torch.clamp(stats[C:2 * C] / stats[-1] - mean * mean, min=0.0)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean[:, None, None]) * scale[:, None, None]
            + bn.bias[:, None, None]).to(x.dtype)


def synced_norm(rank: int) -> dict:
    """Per dtype (f32, bf16): the synced batch norm of this rank's seeded
    piece (an offset mean, so E[x²] - E[x]² cancels) through the module
    and through `synced_norm_by_autograd` -> outputs and the gradients of
    the input, weight and bias under a seeded cotangent."""
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator().manual_seed(rank)
        x = (torch.randn(2, 6, 5, 7, generator=gen) * 0.7 + 3.0).to(dtype)
        cot = torch.randn(x.shape, generator=gen).to(dtype)
        bn = BatchNorm2d(6)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.uniform_(-1.0, 1.0, generator=gen)
        bn.train()
        bn.process_group = dist.group.WORLD
        for how, fn in (("module", bn), ("autograd", lambda t: synced_norm_by_autograd(bn, t))):
            t = x.clone().requires_grad_(True)
            bn.zero_grad(set_to_none=True)
            y = fn(t)
            (y.float() * cot.float()).sum().backward()
            for key, v in (("out", y), ("grad_x", t.grad), ("grad_w", bn.weight.grad),
                           ("grad_b", bn.bias.grad)):
                out[f"synced_norm/{name}/{how}/{key}"] = v.detach().float().numpy()
    return out


def run(out_dir) -> None:
    init_distributed("cpu", timeout_s=60)
    torch.set_num_threads(1)
    mesh = make_mesh(1, N, "cpu")
    r = mesh.spatial_index
    mods = modules()
    result = {}
    for name, (fn, _, kind, height, out_axis) in CASES.items():
        mine = {k: piece(t, axis, r).requires_grad_(True)
                for k, (t, axis) in inputs(name).items()}
        with rows.row_sharding(mesh, height):
            outs = as_list(fn(mods, *mine.values()))
        loss = 0.0
        for k, out in enumerate(outs):
            if kind == "rows":
                whole = list(out.shape)
                whole[out_axis] *= N
                loss = loss + (out * piece(cotangent(name, k, whole), out_axis, r)).sum()
            elif kind == "whole":
                loss = loss + (out * cotangent(name, k, out.shape, r)).sum()
            else:
                loss = loss + out
            result[f"{name}/out{k}"] = out.detach().numpy()
        loss.backward()
        for key, t in mine.items():
            result[f"{name}/grad_{key}"] = t.grad.numpy()
    result.update(synced_norm(mesh.rank))
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **result)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    codes = spawn(run, N, sys.argv[1], deadline_s=600)
    sys.exit(0 if codes == [0] * N else 1)
