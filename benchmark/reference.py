"""The plain reference: Monodepth2's train step in plain PyTorch, written
from the published model and loss (github.com/nianticlabs/monodepth2:
networks/, layers.py, trainer.py) and from the port's stated semantics
where the two differ.

It imports nothing of the program, nor JAX. Module and state_dict names are
the official ones (torchvision ResNet, `decoder.{i}` of the depth decoder,
`net.{i}` of the pose decoder), so one seeded state_dict loads into this
model and into the program's alike.

Where it follows the port's stated semantics and not the official code:
- colour jitter on the decoded float frames, in the fixed order brightness,
  contrast, saturation, hue (torchvision permutes the order; PIL rounds);
- the target pyramid by 2x2 area averages (the official loader resizes with
  PIL's antialias);
- batch norm's running variance blends the biased batch variance;
- the axis-angle guard is |v| + 1e-5 (official: 1e-7).

`Numerics` sets the arithmetic: f32 with TF32 off (the reference), f64 (the
CPU tests), the control: every convolution's operands rounded to fp8 and
the loss stack in bf16, the nearest precision below what a configuration
states (bf16 network, f32 loss stack); or that stated precision itself,
each convolution's operands and output in bf16 as autocast runs them
(`PROGRAM_PRECISION`), which shows how far that rounding alone moves each
number.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

STAGES = {18: ((2, 2, 2, 2), "basic"), 34: ((3, 4, 6, 3), "basic"),
          50: ((3, 4, 6, 3), "bottleneck"), 101: ((3, 4, 23, 3), "bottleneck"),
          152: ((3, 8, 36, 3), "bottleneck")}
DECODER_CHANNELS = (16, 32, 64, 128, 256)
ADAM = (0.9, 0.999, 1e-8)


@dataclasses.dataclass(frozen=True)
class Numerics:
    """stack: the dtype of everything outside the networks' convolutions
    (geometry, warps, SSIM, loss, batch norm); fp8: round each
    convolution's input and weight (forward) and its output gradient
    (backward) to fp8; net: where set, each convolution's operands and
    output in this dtype (its gradients too, by autograd)."""
    stack: torch.dtype = torch.float32
    fp8: bool = False
    net: torch.dtype | None = None


F32 = Numerics()
F64 = Numerics(stack=torch.float64)
CONTROL = Numerics(stack=torch.bfloat16, fp8=True)
PROGRAM_PRECISION = Numerics(net=torch.bfloat16)
# the control, then each half of it
CONTROLS = {"control": CONTROL, "fp8_convs": Numerics(fp8=True),
            "bf16_stack": Numerics(stack=torch.bfloat16)}


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled fp8: e4m3 forward, e5m2 for the gradient."""

    @staticmethod
    def _round(x: Tensor, dtype, top: float) -> Tensor:
        scale = top / x.detach().abs().amax().clamp_min(1e-12)
        return (x * scale).to(dtype).to(x.dtype) / scale

    @staticmethod
    def forward(ctx, x):
        return _Fp8._round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _Fp8._round(grad, torch.float8_e5m2, 57344.0)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, numerics: Numerics = F32, **kwargs):
        super().__init__(*args, **kwargs)
        self.numerics = numerics

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.numerics.fp8:
            x, w = _Fp8.apply(x), _Fp8.apply(w)
        net = self.numerics.net
        if net is None:
            return self._conv_forward(x, w, b)
        return self._conv_forward(x.to(net), w.to(net),
                                  None if b is None else b.to(net)).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """Train mode: normalise by the batch's mean and biased variance, and
    blend that same biased variance into the running one."""

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean((0, 2, 3))
            var = (x - mean[:, None, None]).square().mean((0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1 - m).add_(m * var.to(self.running_var.dtype))
                self.num_batches_tracked.add_(1)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride, downsample, numerics):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 3, stride, 1, bias=False, numerics=numerics)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, 1, 1, bias=False, numerics=numerics)
        self.bn2 = BatchNorm2d(width)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride, downsample, numerics):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False, numerics=numerics)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, bias=False, numerics=numerics)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False, numerics=numerics)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResnetEncoder(nn.Module):
    """torchvision's ResNet without its head, over `num_input_images`
    channel-stacked images -> the 5-level pyramid (Monodepth2's
    ResnetEncoder)."""

    def __init__(self, num_layers: int, num_input_images: int, numerics: Numerics):
        super().__init__()
        depths, kind = STAGES[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False,
                            numerics=numerics)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (depth, width) in enumerate(zip(depths, (64, 128, 256, 512)), 1):
            blocks = []
            for i in range(depth):
                stride = 2 if stage > 1 and i == 0 else 1
                down = None
                if i == 0 and (stride != 1 or cin != width * block.expansion):
                    down = nn.Sequential(
                        Conv2d(cin, width * block.expansion, 1, stride, bias=False,
                               numerics=numerics),
                        BatchNorm2d(width * block.expansion))
                blocks.append(block(cin, width, stride, down, numerics))
                cin = width * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.channels = [64] + [w * block.expansion for w in (64, 128, 256, 512)]

    def forward(self, x) -> List[Tensor]:
        x = (x.to(self.conv1.weight.dtype) - 0.45) / 0.225
        features = [F.relu(self.bn1(self.conv1(x)))]
        x = F.max_pool2d(features[-1], 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            features.append(x)
        return features


class Conv3x3(nn.Module):
    def __init__(self, cin, cout, numerics):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, numerics=numerics)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, numerics):
        super().__init__()
        self.conv = Conv3x3(cin, cout, numerics)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    """Monodepth2's DepthDecoder: the convs in `decoder`, in the order
    upconv (4,0), (4,1), ..., (0,1), then dispconv s for s in scales."""

    def __init__(self, enc: Sequence[int], scales: Sequence[int], numerics: Numerics):
        super().__init__()
        self.scales = tuple(scales)
        convs = []
        for i in range(4, -1, -1):
            cin = enc[-1] if i == 4 else DECODER_CHANNELS[i + 1]
            convs.append(ConvBlock(cin, DECODER_CHANNELS[i], numerics))
            cin = DECODER_CHANNELS[i] + (enc[i - 1] if i > 0 else 0)
            convs.append(ConvBlock(cin, DECODER_CHANNELS[i], numerics))
        convs += [Conv3x3(DECODER_CHANNELS[s], 1, numerics) for s in self.scales]
        self.decoder = nn.ModuleList(convs)

    def forward(self, features) -> Dict[int, Tensor]:
        out, x = {}, features[-1]
        for n, i in enumerate(range(4, -1, -1)):
            x = self.decoder[2 * n](x)
            x = [F.interpolate(x, scale_factor=2, mode="nearest")]
            if i > 0:
                x.append(features[i - 1])
            x = self.decoder[2 * n + 1](torch.cat(x, 1))
            if i in self.scales:
                out[i] = torch.sigmoid(self.decoder[10 + self.scales.index(i)](x))
        return out


class PoseDecoder(nn.Module):
    """Monodepth2's PoseDecoder on one pyramid, predicting 2 frames."""

    def __init__(self, enc: Sequence[int], numerics: Numerics):
        super().__init__()
        self.net = nn.ModuleList([
            Conv2d(enc[-1], 256, 1, numerics=numerics),
            Conv2d(256, 256, 3, 1, 1, numerics=numerics),
            Conv2d(256, 256, 3, 1, 1, numerics=numerics),
            Conv2d(256, 12, 1, numerics=numerics)])

    def forward(self, features) -> Tuple[Tensor, Tensor]:
        out = F.relu(self.net[0](features[-1]))
        out = F.relu(self.net[1](out))
        out = F.relu(self.net[2](out))
        out = 0.01 * self.net[3](out).mean(3).mean(2).reshape(-1, 2, 1, 6)
        return out[..., :3], out[..., 3:]


class Monodepth2(nn.Module):
    """The `separate` wiring: depth ResNet + DepthDecoder, pose ResNet over
    frame pairs + PoseDecoder."""

    def __init__(self, num_layers: int, scales: Sequence[int],
                 numerics: Numerics = F32):
        super().__init__()
        self.numerics = numerics
        self.encoder = ResnetEncoder(num_layers, 1, numerics)
        enc = self.encoder.channels
        self.decoder = DepthDecoder(enc, scales, numerics)
        self.pose_encoder = ResnetEncoder(num_layers, 2, numerics)
        self.pose_decoder = PoseDecoder(enc, numerics)


def build(cfg: dict, numerics: Numerics = F32, device="cpu") -> Monodepth2:
    """The reference model of configuration `cfg` (a configuration file's
    fields), uninitialised, on `device` (the meta device gives the names
    and shapes alone)."""
    if cfg["pose_type"] != "separate" or cfg.get("pose_frames", 2) != 2:
        raise ValueError("the reference implements the `separate` pose wiring "
                         "over frame pairs")
    with torch.device(device):
        return Monodepth2(cfg["num_layers"], cfg["scales"], numerics)


# --- the loss stack -----------------------------------------------------------

def _gray(x: Tensor) -> Tensor:
    return (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]


def _rgb_to_hsv(x: Tensor) -> Tensor:
    r, g, b = x.unbind(1)
    maxc, minc = x.amax(1), x.amin(1)
    same = maxc == minc
    span = maxc - minc
    s = span / torch.where(same, torch.ones_like(maxc), maxc)
    div = torch.where(same, torch.ones_like(span), span)
    rc, gc, bc = (maxc - r) / div, (maxc - g) / div, (maxc - b) / div
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(same, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, maxc], 1)


def _hsv_to_rgb(x: Tensor) -> Tensor:
    h, s, v = x.unbind(1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.to(torch.int64) % 6
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    table = torch.stack([torch.stack(c, 1) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))], 1)
    return table.gather(1, i[:, None, None].expand(-1, 1, 3, -1, -1))[:, 0]


def color_jitter(x: Tensor, jitter: Tensor) -> Tensor:
    """x [N, 3, H, W] in [0, 1]; jitter [N, 5] = [apply, brightness,
    contrast, saturation, hue]."""
    j = jitter.to(x.dtype)[:, :, None, None, None]
    out = (x * j[:, 1]).clamp(0, 1)
    out = (j[:, 2] * out + (1 - j[:, 2]) * _gray(out).mean((2, 3), keepdim=True)).clamp(0, 1)
    out = (j[:, 3] * out + (1 - j[:, 3]) * _gray(out)).clamp(0, 1)
    hsv = _rgb_to_hsv(out)
    hsv = torch.cat([torch.remainder(hsv[:, :1] + j[:, 4], 1.0), hsv[:, 1:]], 1)
    out = _hsv_to_rgb(hsv).clamp(0, 1)
    return torch.where(j[:, 0] > 0, out, x)


def disp_to_depth(disp: Tensor, min_depth: float, max_depth: float):
    min_disp, max_disp = 1 / max_depth, 1 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    return scaled, 1 / scaled


def transformation_from_parameters(axisangle: Tensor, translation: Tensor,
                                   invert: bool) -> Tensor:
    angle = torch.linalg.vector_norm(axisangle, dim=-1, keepdim=True)
    axis = axisangle / (angle + 1e-5)
    ca, sa = torch.cos(angle)[:, 0], torch.sin(angle)[:, 0]
    C = 1 - ca
    x, y, z = axis.unbind(-1)
    R = torch.zeros(axisangle.shape[0], 4, 4, dtype=axisangle.dtype,
                    device=axisangle.device)
    R[:, 0, 0], R[:, 0, 1], R[:, 0, 2] = x * x * C + ca, x * y * C - z * sa, z * x * C + y * sa
    R[:, 1, 0], R[:, 1, 1], R[:, 1, 2] = x * y * C + z * sa, y * y * C + ca, y * z * C - x * sa
    R[:, 2, 0], R[:, 2, 1], R[:, 2, 2] = z * x * C - y * sa, y * z * C + x * sa, z * z * C + ca
    R[:, 3, 3] = 1
    t = translation.clone()
    if invert:
        R, t = R.transpose(1, 2), -t
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return R @ T if invert else T @ R


def sample_grid(depth: Tensor, K: Tensor, inv_K: Tensor, T: Tensor) -> Tensor:
    """BackprojectDepth then Project3D: depth [B, 1, H, W] -> grid [B, H, W, 2]."""
    B, _, H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs.flatten(), ys.flatten(), torch.ones_like(xs.flatten())])
    cam = depth.reshape(B, 1, -1) * (inv_K[:, :3, :3] @ pix)
    cam = torch.cat([cam, torch.ones_like(cam[:, :1])], 1)
    pts = ((K @ T)[:, :3, :]) @ cam
    xy = pts[:, :2] / (pts[:, 2:3] + 1e-7)
    xy = xy.reshape(B, 2, H, W).permute(0, 2, 3, 1)
    xy = xy / torch.tensor([W - 1, H - 1], dtype=xy.dtype, device=xy.device)
    return (xy - 0.5) * 2


def ssim(x: Tensor, y: Tensor) -> Tensor:
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    x, y = F.pad(x, (1, 1, 1, 1), mode="reflect"), F.pad(y, (1, 1, 1, 1), mode="reflect")
    pool = lambda t: F.avg_pool2d(t, 3, 1)  # noqa: E731
    mu_x, mu_y = pool(x), pool(y)
    sigma_x = pool(x * x) - mu_x ** 2
    sigma_y = pool(y * y) - mu_y ** 2
    sigma_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    return torch.clamp((1 - n / d) / 2, 0, 1)


def reprojection_loss(pred: Tensor, target: Tensor) -> Tensor:
    l1 = (target - pred).abs().mean(1, True)
    return 0.85 * ssim(pred, target).mean(1, True) + 0.15 * l1


def smooth_loss(disp: Tensor, img: Tensor) -> Tensor:
    gdx = (disp[:, :, :, :-1] - disp[:, :, :, 1:]).abs()
    gdy = (disp[:, :, :-1, :] - disp[:, :, 1:, :]).abs()
    gix = (img[:, :, :, :-1] - img[:, :, :, 1:]).abs().mean(1, True)
    giy = (img[:, :, :-1, :] - img[:, :, 1:, :]).abs().mean(1, True)
    return (gdx * torch.exp(-gix)).mean() + (gdy * torch.exp(-giy)).mean()


def train_loss(model: Monodepth2, cfg: dict, batch: Dict[str, Tensor],
               noise: Dict[int, Tensor], keep: dict | None = None) -> Tensor:
    """Monodepth2's loss on one batch: frames uint8 [B, F, H, W, 3] in the
    order `cfg["frame_ids"]`, jitter [B, 5], K and inv_K [B, 4, 4] and,
    with the stereo frame "s", stereo_T [B, 4, 4], which warps it in place
    of a pose network's transform; noise {scale: [B, H, W, n_sources]},
    the automask's tie-break noise. `keep`, when given, gets the finest
    scale's disparity [B, 1, H, W] as "disp"."""
    stack = model.numerics.stack
    frames = batch["frames"]
    B, nf, H, W, _ = frames.shape
    ids = list(cfg["frame_ids"])
    color = frames.permute(0, 1, 4, 2, 3).to(stack) / 255.0        # [B, F, 3, H, W]
    aug = color_jitter(color.reshape(B * nf, 3, H, W),
                       batch["jitter"].repeat_interleave(nf, 0)).reshape(color.shape)
    frame = lambda t, f: t[:, ids.index(f)]  # noqa: E731
    disps = model.decoder(model.encoder(frame(aug, 0)))
    if keep is not None:
        keep["disp"] = disps[min(cfg["scales"])].detach().clone()
    poses = {}
    if "s" in ids:
        poses["s"] = batch["stereo_T"].to(stack)
    for f in ids[1:]:
        if f == "s":
            continue
        pair = (f, 0) if f < 0 else (0, f)
        axisangle, translation = model.pose_decoder(
            model.pose_encoder(torch.cat([frame(aug, p) for p in pair], 1)))
        poses[f] = transformation_from_parameters(
            axisangle[:, 0, 0].to(stack), translation[:, 0, 0].to(stack), invert=f < 0)

    K, inv_K = batch["K"].to(stack), batch["inv_K"].to(stack)
    target = frame(color, 0)
    pyramid = [target]
    for _ in range(max(cfg["scales"])):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2))
    sources = [frame(color, f) for f in ids[1:]]
    identity = torch.cat([reprojection_loss(s, target) for s in sources], 1)
    total = 0.0
    for scale in cfg["scales"]:
        disp = disps[scale].to(stack)
        up = F.interpolate(disp, [H, W], mode="bilinear", align_corners=False)
        _, depth = disp_to_depth(up, cfg["min_depth"], cfg["max_depth"])
        reproj = torch.cat([reprojection_loss(
            F.grid_sample(s, sample_grid(depth, K, inv_K, poses[f]),
                          padding_mode="border", align_corners=True), target)
            for f, s in zip(ids[1:], sources)], 1)
        tie = noise[scale].permute(0, 3, 1, 2).to(stack)
        combined = torch.cat([identity + tie, reproj], 1)
        total = total + combined.amin(1).mean()
        norm = disp / (disp.mean(2, True).mean(3, True) + 1e-7)
        total = total + cfg["disp_smoothness"] * smooth_loss(norm, pyramid[scale]) / 2 ** scale
    return total / len(cfg["scales"])


def adam_update(params: Sequence[Tensor], grads: Sequence[Tensor],
                moments: List[Tuple[Tensor, Tensor]], step: int, lr: float) -> None:
    """One Adam step (b1 0.9, b2 0.999, eps 1e-8) in place; `step` counts
    from 1."""
    b1, b2, eps = ADAM
    with torch.no_grad():
        for p, g, (m, v) in zip(params, grads, moments):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** step)
            v_hat = v / (1 - b2 ** step)
            p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


@dataclasses.dataclass
class Trajectory:
    """What the reference's first steps give: the loss of each step, the
    first two steps' gradients, the first step's finest disparity, the
    parameters after the first step and, after the last step, the
    parameters and the batch-norm running statistics."""
    losses: List[float]
    grad1: Dict[str, Tensor]
    grad2: Dict[str, Tensor]
    params: Dict[str, Tensor]
    stats: Dict[str, Tensor]
    disp1: Tensor
    params1: Dict[str, Tensor]


def loss_and_grads(model: Monodepth2, cfg: dict, batch: Dict[str, Tensor],
                   noise: Dict[int, Tensor], keep: dict | None = None):
    """One forward and backward of `model` in train mode -> (loss, {name:
    gradient})."""
    model.train()
    named = list(model.named_parameters())
    loss = train_loss(model, cfg, batch, noise, keep)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss.detach()), {n: g.detach() for (n, _), g in zip(named, grads)}


def train_steps(model: Monodepth2, cfg: dict, batches: Sequence[Dict[str, Tensor]],
                noises: Sequence[Dict[int, Tensor]], lr) -> Trajectory:
    """len(batches) train steps of `model` (loaded, on its device) with Adam
    from zero moments at rate `lr` (or, a list, one rate a step)."""
    named = [(n, p) for n, p in model.named_parameters()]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for _, p in named]
    rates = list(lr) if isinstance(lr, (list, tuple)) else [lr] * len(batches)
    losses, grad, first, params1 = [], [], {}, {}
    for k, (batch, noise) in enumerate(zip(batches, noises), 1):
        loss, grads = loss_and_grads(model, cfg, batch, noise, first if k == 1 else None)
        losses.append(loss)
        if k <= 2:
            grad.append(grads)
        adam_update([p for _, p in named], [grads[n].to(p.dtype) for n, p in named],
                    moments, k, rates[k - 1])
        if k == 1:
            params1 = {n: p.detach().clone() for n, p in named}
        del grads
    return Trajectory(losses, grad[0], grad[-1],
                      {n: p.detach().clone() for n, p in named},
                      {n: b.detach().clone() for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))},
                      first["disp"], params1)


def fan_init_std(name: str, shape: Sequence[int]) -> float:
    """The seeded init's standard deviation of a convolution weight: He
    normal over fan-out in the encoders (torchvision's ResNet init), LeCun
    normal over fan-in in the decoders."""
    receptive = math.prod(shape[2:])
    if name.startswith(("encoder.", "pose_encoder.")):
        return math.sqrt(2.0 / (shape[0] * receptive))
    return math.sqrt(1.0 / (shape[1] * receptive))
