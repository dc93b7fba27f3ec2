"""ResNet encoder for depth and pose, NCHW, torchvision state_dict names.

Counterpart of `monodepth_tpu.models.resnet` (reference:
model_layer/depth_encoder.py:14-101): ResNet-{18,34,50,101,152} returning
the 5-level pyramid [relu1, layer1, layer2, layer3, layer4] with channels
[64, 64, 128, 256, 512] (x4 from layer1 up for depths >= 50). conv1 takes
`num_input_images * 3` channels. Inputs in [0, 1] are normalized
(x - 0.45) / 0.225 inside. BN eps 1e-5, momentum 0.1 (flax's 0.9), and
in train mode it keeps flax's biased running variance (`BatchNorm2d`),
and under `sync_batch_stats` it normalizes with the statistics of the
global batch of a data-parallel step; max-pool pads with -inf. Names
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
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        C = x.shape[1]
        count = torch.full((1,), float(x.numel() // C), dtype=dtype,
                           device=x.device)
        stats = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)),
                                          (xf * xf).sum((0, 2, 3)), count]),
                               self.process_group)
        mean = stats[:C] / stats[-1]
        var = torch.clamp(stats[C:2 * C] / stats[-1] - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        if self.keep_stats:
            return out.to(x.dtype)
        with torch.no_grad():
            for buf, value in ((self.running_mean, mean), (self.running_var, var)):
                buf.mul_(1.0 - self.momentum).add_(value.to(buf.dtype),
                                                   alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return out.to(x.dtype)


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
    that forward. The recomputation runs in the backward, outside
    `sync_batch_stats`, and sums the statistics over the group again,
    which gives the forward's values."""

    def __init__(self, module: nn.Module):
        self._norms = [(m, m.process_group) for m in module.modules()
                       if isinstance(m, BatchNorm2d)]
        self._outside = []

    def __enter__(self):
        self._outside = [m.process_group for m, _ in self._norms]
        for m, group in self._norms:
            m.keep_stats = True
            m.process_group = group
        return self

    def __exit__(self, *exc):
        for (m, _), group in zip(self._norms, self._outside):
            m.keep_stats = False
            m.process_group = group


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1):
    conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
    return conv, BatchNorm2d(cout, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, width, 3, stride)
        self.conv2, self.bn2 = _conv_bn(width, width, 3)
        self.downsample = nn.Sequential(*_conv_bn(cin, width, 1, stride)) \
            if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
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
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
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
        x = (x - 0.45) / 0.225
        f0 = torch.relu(self.bn1(self.conv1(x)))
        features = [f0]
        x = self.maxpool(f0)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            if self.remat and torch.is_grad_enabled():
                for block in stage:
                    # no random numbers are drawn, so no RNG state is kept
                    # (it cannot be read while a CUDA graph is captured)
                    x = checkpoint(block, x, use_reentrant=False,
                                   preserve_rng_state=False,
                                   context_fn=lambda b=block: (
                                       contextlib.nullcontext(), Recomputation(b)))
            else:
                x = stage(x)
            features.append(x)
        return features
