"""Official-layout PyTorch state_dicts -> the Flax parameter trees of the
JAX package's per-module npz exports (numpy only).

A copy of `monodepth_tpu.utils.torch_import`, so the port writes the npz
sets that both packages' eval CLIs read
(`monodepth_tpu_torch/tools/convert_torch_weights.py`); `jax_import`
reads them back into this package's modules:

- torchvision `resnet{18,34,50,101,152}` and Monodepth2 encoders ->
  ResNetEncoder params/batch_stats, with the multi-image conv1 rule: conv1
  tiled across the input-image axis and divided by the image count
  (reference: depth_encoder.py:59);
- official Monodepth2 `depth.pth` -> DepthDecoder;
- official Monodepth2 `pose.pth` -> PoseDecoder; PoseCNN checkpoints ->
  PoseCNN.

Torch conv weights are [O, I, kH, kW]; Flax wants [kH, kW, I, O].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from monodepth_tpu_torch.models.resnet import STAGES


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def _f(t) -> np.ndarray:
    """To float32, except float64 stays float64 (f64 parity harnesses)."""
    a = _np(t)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _conv(t) -> np.ndarray:
    return _f(_np(t).transpose(2, 3, 1, 0))


def load_torch_file(path: str) -> Dict[str, Any]:
    """torch.load a .pt/.pth state_dict on the CPU, dropping non-tensor and
    0-d entries (official encoder checkpoints carry 'height'/'width' keys,
    reference: model_test.py:37-38; num_batches_tracked is 0-d)."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    return {k: _np(v) for k, v in raw.items()
            if hasattr(v, "detach") and getattr(v, "ndim", 0) >= 1}


def _strip_prefix(sd: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return dict(sd)


def _bn(sd, key) -> Tuple[dict, dict]:
    params = {"scale": _f(sd[f"{key}.weight"]),
              "bias": _f(sd[f"{key}.bias"])}
    stats = {"mean": _f(sd[f"{key}.running_mean"]),
             "var": _f(sd[f"{key}.running_var"])}
    return params, stats


def resnet_encoder_variables(state_dict: Mapping[str, np.ndarray],
                             num_layers: int,
                             num_input_images: int = 1) -> Dict[str, Any]:
    """torchvision / Monodepth2-encoder state_dict -> ResNetEncoder variables
    {"params": ..., "batch_stats": ...}."""
    sd = _strip_prefix(state_dict, "encoder.")
    depths, block_name = STAGES[num_layers]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    conv1 = _conv(sd["conv1.weight"])  # [7,7,in,64]
    if num_input_images > 1 and conv1.shape[2] == 3:
        conv1 = np.concatenate([conv1] * num_input_images, axis=2) / num_input_images
    params["conv1"] = {"kernel": conv1}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")

    n_convs = 2 if block_name == "basic" else 3
    for stage, depth in enumerate(depths, start=1):
        for i in range(depth):
            src = f"layer{stage}.{i}"
            dst = f"layer{stage}_{i}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for c in range(1, n_convs + 1):
                bn_p, bn_s = _bn(sd, f"{src}.bn{c}")
                bp[f"cb{c}"] = {"conv": {"kernel": _conv(sd[f"{src}.conv{c}.weight"])},
                                "bn": bn_p}
                bs[f"cb{c}"] = {"bn": bn_s}
            if f"{src}.downsample.0.weight" in sd:
                bn_p, bn_s = _bn(sd, f"{src}.downsample.1")
                bp["downsample"] = {
                    "conv": {"kernel": _conv(sd[f"{src}.downsample.0.weight"])},
                    "bn": bn_p}
                bs["downsample"] = {"bn": bn_s}
            params[dst] = bp
            stats[dst] = bs
    return {"params": params, "batch_stats": stats}


def depth_decoder_params(state_dict: Mapping[str, np.ndarray],
                         scales=(0, 1, 2, 3)) -> Dict[str, Any]:
    """Official Monodepth2 depth.pth -> DepthDecoder params.

    The torch module registers its convs as ModuleList entries in the
    order [upconv_4_0, upconv_4_1, ..., upconv_0_1, dispconv_0..3]
    (reference: depth_decoder.py:72-92), so keys are 'decoder.{idx}...'.
    """
    sd = dict(state_dict)
    names = []
    for i in range(4, -1, -1):
        names += [f"upconv_{i}_0", f"upconv_{i}_1"]
    names += [f"dispconv_{s}" for s in scales]

    params: Dict[str, Any] = {}
    for idx, name in enumerate(names):
        if name.startswith("upconv"):  # ConvBlock -> .conv.conv
            w = sd[f"decoder.{idx}.conv.conv.weight"]
            b = sd[f"decoder.{idx}.conv.conv.bias"]
            params[name] = {"conv": {"conv": {"kernel": _conv(w),
                                              "bias": _f(b)}}}
        else:  # Conv3x3 -> .conv
            w = sd[f"decoder.{idx}.conv.weight"]
            b = sd[f"decoder.{idx}.conv.bias"]
            params[name] = {"conv": {"kernel": _conv(w),
                                     "bias": _f(b)}}
    return params


def pose_decoder_params(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Official Monodepth2 pose.pth -> PoseDecoder params.
    ModuleList order: [squeeze, pose_0, pose_1, pose_2]."""
    sd = dict(state_dict)

    def entry(idx):
        return {"kernel": _conv(sd[f"net.{idx}.weight"]),
                "bias": _f(sd[f"net.{idx}.bias"])}

    return {"squeeze": entry(0), "pose_0": entry(1),
            "pose_1": entry(2), "pose_2": entry(3)}


def pose_cnn_params(state_dict: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Monodepth2 PoseCNN checkpoint -> PoseCNN params.
    Keys: net.{0..6}.weight/bias + pose_conv.weight/bias."""
    sd = dict(state_dict)
    params = {}
    for i in range(7):
        params[f"conv_{i}"] = {"kernel": _conv(sd[f"net.{i}.weight"]),
                               "bias": _f(sd[f"net.{i}.bias"])}
    params["pose_conv"] = {"kernel": _conv(sd["pose_conv.weight"]),
                           "bias": _f(sd["pose_conv.bias"])}
    return params
