"""ResNet encoder for depth and pose, NCHW, torchvision state_dict names.

Counterpart of `monodepth_tpu.models.resnet` (reference:
model_layer/depth_encoder.py:14-101): ResNet-{18,34,50,101,152} returning
the 5-level pyramid [relu1, layer1, layer2, layer3, layer4] with channels
[64, 64, 128, 256, 512] (x4 from layer1 up for depths >= 50). conv1 takes
`num_input_images * 3` channels. Inputs in [0, 1] are normalized
(x - 0.45) / 0.225 inside. BN eps 1e-5, momentum 0.1 (flax's 0.9), and
in train mode it keeps flax's biased running variance (`BatchNorm2d`),
and under `sync_batch_stats` it normalizes with the statistics of the
global batch of a mesh step (summed over the data ranks, and over the
spatial ranks' row pieces); max-pool pads with -inf. Under a spatial mesh
every convolution and the max pool run on this rank's rows with halo rows
from its neighbours, level by level as `parallel.rows`' level rule says.
Names
follow torchvision (conv1, bn1,
layer1.0.conv2, layer2.0.downsample.0, ...), so torchvision and official
Monodepth2 encoder checkpoints load as they are. With `remat`, each
residual block's activations are recomputed in the backward instead of
kept (flax's `nn.remat` of the JAX encoder); the recomputation leaves the
running statistics alone, so a step updates them once, as flax does.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from monodepth_tpu_torch.parallel import rows
from monodepth_tpu_torch.parallel.mesh import all_reduce_sum

# stage depths and block type per torchvision resnet variant
STAGES = {
    18: ((2, 2, 2, 2), "basic"),
    34: ((3, 4, 6, 3), "basic"),
    50: ((3, 4, 6, 3), "bottleneck"),
    101: ((3, 4, 23, 3), "bottleneck"),
    152: ((3, 8, 36, 3), "bottleneck"),
}


def num_ch_enc(num_layers: int) -> np.ndarray:
    """Encoder pyramid channel counts."""
    ch = np.array([64, 64, 128, 256, 512])
    if num_layers > 34:
        ch[1:] *= 4
    return ch


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update stores the biased batch
    variance in `running_var`, as flax's `BatchNorm` does:
    running_var = 0.9·running_var + 0.1·var(ddof=0). `nn.BatchNorm2d`
    stores the unbiased one (times n/(n-1), n = N·H·W). Both normalize the
    batch with the biased variance, so only the running statistics differ.

    torch's update runs on copies of the buffers, the variance scaled by
    n/(n-1), and the result is scaled back into the buffers, which leaves
    exactly the biased blend. (Batch norm keeps the statistics it was
    given for its backward, so the buffers themselves are not rescaled in
    place around the call.) Buffers and state_dict names are those of
    `nn.BatchNorm2d`.

    With a `process_group` (set by `sync_batch_stats`), train mode sums
    the per-channel count, sum and sum of squares over the group and
    normalizes with the global batch's mean and biased variance
    E[x²] - E[x]² (flax's fast variance, floored at 0), as flax does
    under a data-sharded mesh; the running statistics take the same
    biased blend. `nn.SyncBatchNorm` would store the unbiased variance.

    While `keep_stats` is set (`Recomputation`, around a checkpointed
    block's recomputation), train mode normalizes as always but leaves the
    running statistics and `num_batches_tracked` as they are."""

    process_group = None
    keep_stats = False

    def forward(self, x):
        n = x.numel() // x.shape[1]
        if self.training and self.track_running_stats \
                and self.process_group is not None:
            return self._synced(x)
        if not (self.training and self.track_running_stats) or n < 2:
            return super().forward(x)
        unbias = n / (n - 1)
        mean = self.running_mean.clone()
        var = self.running_var * unbias
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                           self.momentum, self.eps)
        if self.keep_stats:
            return out
        with torch.no_grad():
            self.running_mean.copy_(mean)
            torch.div(var, unbias, out=self.running_var)
            self.num_batches_tracked.add_(1)
        return out

    def _synced(self, x):
        out, mean, var = _SyncedNorm.apply(x, self.weight, self.bias, self.eps,
                                           self.process_group)
        if not self.keep_stats:
            with torch.no_grad():
                for buf, value in ((self.running_mean, mean), (self.running_var, var)):
                    buf.mul_(1.0 - self.momentum).add_(value.to(buf.dtype),
                                                       alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return out


class _SyncedNorm(torch.autograd.Function):
    """`BatchNorm2d._synced`'s normalization -> (output in x's dtype, the
    global mean, the global biased variance), computed in f32 or wider.
    It keeps x in its own dtype for the backward, not the f32 copies of x
    and of x - mean that autograd of the same ops keeps, and its backward
    is that autograd's bit for bit: the same ops, the sums that autograd
    accumulates added in its order, and the statistics' cotangents summed
    over the group in one all-reduce of the same length
    (`tests/test_torch_rows.py` holds the two equal on three ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        C = x.shape[1]
        count = torch.full((1,), float(x.numel() // C), dtype=dtype,
                           device=x.device)
        stats = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)),
                                          (xf * xf).sum((0, 2, 3)), count]), group)
        total = stats[-1]
        mean = stats[:C] / total
        raw = stats[C:2 * C] / total - mean * mean
        var = torch.clamp(raw, min=0.0)
        rs = torch.rsqrt(var + eps)
        out = (xf - mean[:, None, None]) * (rs * weight)[:, None, None] \
            + bias[:, None, None]
        ctx.save_for_backward(x, weight, mean, raw, rs, total)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x, weight, mean, raw, rs, total = ctx.saved_tensors
        xf = x.to(mean.dtype)
        g = grad.to(mean.dtype)
        d_bias = g.sum((0, 2, 3))
        d_centered = g * (rs * weight)[:, None, None]
        d_scale = (g * (xf - mean[:, None, None])).sum((0, 2, 3))
        # rsqrt, then the clamp at 0, then E[x²] - mean²
        d_raw = torch.where(raw >= 0, -0.5 * (d_scale * weight) * rs.pow(3), 0.0)
        d_mean = (-d_centered).sum((0, 2, 3)) + -d_raw * mean + -d_raw * mean
        sums = all_reduce_sum(torch.cat([d_mean / total, d_raw / total,
                                         d_raw.new_zeros(1)]), ctx.group)
        C = mean.numel()
        d_sq = sums[C:2 * C, None, None] * xf
        dx = d_centered + d_sq + d_sq + sums[:C, None, None]
        return dx.to(x.dtype), d_scale * rs, d_bias, None, None


@contextlib.contextmanager
def sync_batch_stats(model: nn.Module, group) -> Iterator[None]:
    """Within the block, every `BatchNorm2d` of `model` in train mode
    normalizes with the statistics summed over `group` (a process group;
    None leaves each rank's own batch)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.process_group = group
    try:
        yield
    finally:
        for m in norms:
            m.process_group = None


class Recomputation:
    """The context of a checkpointed block's recomputation, made when the
    block runs forward: within it every `BatchNorm2d` of `module` keeps
    its running statistics (`BatchNorm2d.keep_stats`), so the batch is
    not counted twice, and normalizes over the process group it had in
    that forward, on the rows it ran on (`parallel.rows`). The
    recomputation runs in the backward, outside `sync_batch_stats` and
    `row_sharding`, and sums the statistics over the group again, which
    gives the forward's values; a row-sharded block repeats its halo
    exchanges, in the same order on every rank."""

    def __init__(self, module: nn.Module):
        self._norms = [(m, m.process_group) for m in module.modules()
                       if isinstance(m, BatchNorm2d)]
        self._outside = []
        self._rows = rows.state()
        self._rows_outside = None

    def __enter__(self):
        self._outside = [m.process_group for m, _ in self._norms]
        for m, group in self._norms:
            m.keep_stats = True
            m.process_group = group
        self._rows_outside = rows.swap_state(self._rows)
        return self

    def __exit__(self, *exc):
        for (m, _), group in zip(self._norms, self._outside):
            m.keep_stats = False
            m.process_group = group
        rows.swap_state(self._rows_outside)


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1):
    conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
    return conv, BatchNorm2d(cout, eps=1e-5, momentum=0.1)


def _downsample(downsample: nn.Sequential, x):
    conv, bn = downsample
    return bn(rows.conv2d(conv, x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, width, 3, stride)
        self.conv2, self.bn2 = _conv_bn(width, width, 3)
        self.downsample = nn.Sequential(*_conv_bn(cin, width, 1, stride)) \
            if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else _downsample(self.downsample, x)
        out = torch.relu(self.bn1(rows.conv2d(self.conv1, x)))
        out = self.bn2(rows.conv2d(self.conv2, out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, width, 1)
        self.conv2, self.bn2 = _conv_bn(width, width, 3, stride)
        self.conv3, self.bn3 = _conv_bn(width, width * 4, 1)
        self.downsample = nn.Sequential(*_conv_bn(cin, width * 4, 1, stride)) \
            if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else _downsample(self.downsample, x)
        out = torch.relu(self.bn1(rows.conv2d(self.conv1, x)))
        out = torch.relu(self.bn2(rows.conv2d(self.conv2, out)))
        out = self.bn3(rows.conv2d(self.conv3, out))
        return torch.relu(out + identity)


class ResNetEncoder(nn.Module):
    """[B, 3*num_input_images, H, W] in [0, 1] -> features at strides
    [2, 4, 8, 16, 32]. With `remat` and autograd on, each residual block
    runs under `torch.utils.checkpoint` (non-reentrant), its recomputation
    inside a `Recomputation`."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if num_layers not in STAGES:
            raise ValueError(f"{num_layers} is not a valid resnet depth")
        depths, kind = STAGES[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.num_layers = num_layers
        self.num_ch_enc = num_ch_enc(num_layers)
        self.conv1, self.bn1 = _conv_bn(3 * num_input_images, 64, 7, 2)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for stage, (depth, width) in enumerate(zip(depths, (64, 128, 256, 512)),
                                               start=1):
            blocks = []
            for i in range(depth):
                stride = 2 if (stage > 1 and i == 0) else 1
                needs_ds = i == 0 and (stride != 1
                                       or cin != width * block.expansion)
                blocks.append(block(cin, width, stride, needs_ds))
                cin = width * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        # under a spatial mesh the input comes in row pieces; each level
        # runs on them while the level rule holds, then whole
        levels = rows.resnet_levels()
        x = rows.relevel((x - 0.45) / 0.225, rows.current() is not None, levels[1])
        with rows.level(levels[1]):
            f0 = torch.relu(self.bn1(rows.conv2d(self.conv1, x)))
        features = [f0]
        x = rows.relevel(f0, levels[1], levels[2])
        with rows.level(levels[2]):
            x = rows.max_pool2d(self.maxpool, x)
        stages = (self.layer1, self.layer2, self.layer3, self.layer4)
        for stage, was, now in zip(stages, (2, 2, 3, 4), (2, 3, 4, 5)):
            x = rows.relevel(x, levels[was], levels[now])
            with rows.level(levels[now]):
                x = self._stage(stage, x)
            features.append(x)
        return features

    def _stage(self, stage: nn.Sequential, x):
        if not (self.remat and torch.is_grad_enabled()):
            return stage(x)
        for block in stage:
            # no random numbers are drawn, so no RNG state is kept
            # (it cannot be read while a CUDA graph is captured)
            x = checkpoint(block, x, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=lambda b=block: (
                               contextlib.nullcontext(), Recomputation(b)))
        return x
