"""JAX (Flax) variables -> the port's `Monodepth` state_dict.

The exact inverse of `monodepth_tpu.utils.torch_import` for the
`separate` wiring: it takes the `{"params", "batch_stats"}` tree of the
JAX `Monodepth` as numpy arrays (no jax needed) and returns the port's
full state_dict, covering `encoder`, `decoder`, `pose_encoder` and
`pose_decoder`:
- conv kernels go from HWIO to OIHW;
- BN scale/bias/mean/var become weight/bias/running_mean/running_var,
  plus a zero `num_batches_tracked` (JAX keeps no such counter);
- decoder names map to `decoder.decoder.{idx}` in the official order
  [upconv_4_0, upconv_4_1, ..., upconv_0_1, dispconv_s for s in scales];
- pose decoder names map to `pose_decoder.net.{0..3}`.
float64 arrays stay float64, everything else becomes float32.

`module_state_dict` converts one module at a time (the per-module npz
exports that `evaluation.eigen.state_from_modules` reads).
`optimizer_state_from_jax` carries optax's Adam state across by the same
name map, so a JAX run can continue in the port mid-training.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from monodepth_tpu_torch.models.resnet import STAGES


def _f(a) -> torch.Tensor:
    """A copy, f64 kept and anything else f32: the tensor owns writable
    memory (an optimizer updates its state in place)."""
    a = np.asarray(a)
    dtype = np.float64 if a.dtype == np.float64 else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, order="C"))


def _conv(kernel) -> torch.Tensor:
    return _f(np.asarray(kernel).transpose(3, 2, 0, 1))


def _at(tree, key):
    return None if tree is None else tree[key]


def _bn(out, key, params, stats) -> None:
    out[f"{key}.weight"] = _f(params["scale"])
    out[f"{key}.bias"] = _f(params["bias"])
    if stats is None:
        return
    out[f"{key}.running_mean"] = _f(stats["mean"])
    out[f"{key}.running_var"] = _f(stats["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _encoder(out, prefix: str, params, stats, num_layers: int) -> None:
    """One ResNet encoder; `stats` None leaves out the BN buffers."""
    depths, kind = STAGES[num_layers]
    out[f"{prefix}.conv1.weight"] = _conv(params["conv1"]["kernel"])
    _bn(out, f"{prefix}.bn1", params["bn1"], _at(stats, "bn1"))
    n_convs = 2 if kind == "basic" else 3
    for stage, depth in enumerate(depths, start=1):
        for i in range(depth):
            src = params[f"layer{stage}_{i}"]
            src_stats = _at(stats, f"layer{stage}_{i}")
            dst = f"{prefix}.layer{stage}.{i}"
            for c in range(1, n_convs + 1):
                out[f"{dst}.conv{c}.weight"] = _conv(src[f"cb{c}"]["conv"]["kernel"])
                _bn(out, f"{dst}.bn{c}", src[f"cb{c}"]["bn"],
                    _at(_at(src_stats, f"cb{c}"), "bn"))
            if "downsample" in src:
                out[f"{dst}.downsample.0.weight"] = _conv(
                    src["downsample"]["conv"]["kernel"])
                _bn(out, f"{dst}.downsample.1", src["downsample"]["bn"],
                    _at(_at(src_stats, "downsample"), "bn"))


def state_dict_from_jax(variables: Mapping[str, Any], cfg) -> "OrderedDict[str, torch.Tensor]":
    """JAX `Monodepth` variables -> the port's `Monodepth` state_dict."""
    return _monodepth(variables["params"], variables["batch_stats"],
                      cfg.num_layers, cfg.scales)


def module_state_dict(name: str, params, stats: Optional[Mapping],
                      num_layers: int, scales) -> "OrderedDict[str, torch.Tensor]":
    """One top-level module of the JAX `Monodepth` (`encoder`, `decoder`,
    `pose_encoder` or `pose_decoder`: its params tree, and its
    batch_stats tree or None) -> that module's tensors under the port's
    names; `stats` None leaves out the BN buffers. For the per-module npz
    exports, which may hold some modules and not others."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if name in ("encoder", "pose_encoder"):
        _encoder(out, name, params, stats, num_layers)
    elif name == "decoder":
        names = []
        for i in range(4, -1, -1):
            names += [f"upconv_{i}_0", f"upconv_{i}_1"]
        names += [f"dispconv_{s}" for s in scales]
        for idx, conv in enumerate(names):
            p = params[conv]["conv"]
            key = f"decoder.decoder.{idx}.conv"
            if conv.startswith("upconv"):  # ConvBlock -> Conv3x3 -> Conv2d
                p, key = p["conv"], f"{key}.conv"
            out[f"{key}.weight"] = _conv(p["kernel"])
            out[f"{key}.bias"] = _f(p["bias"])
    elif name == "pose_decoder":
        for idx, conv in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
            p = params[conv]
            out[f"pose_decoder.net.{idx}.weight"] = _conv(p["kernel"])
            out[f"pose_decoder.net.{idx}.bias"] = _f(p["bias"])
    else:
        raise ValueError(f"unknown module {name!r}")
    return out


def _monodepth(params, stats: Optional[Mapping], num_layers: int,
               scales) -> "OrderedDict[str, torch.Tensor]":
    """A tree shaped like the JAX `Monodepth` params -> tensors under the
    port's names; `stats` None leaves out the BN buffers."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in ("encoder", "decoder", "pose_encoder", "pose_decoder"):
        module_stats = None if stats is None else stats.get(name)
        out.update(module_state_dict(name, params[name], module_stats,
                                     num_layers, scales))
    return out


def optimizer_state_from_jax(opt_state, model: nn.Module) -> dict:
    """optax Adam state -> a `torch.optim.Adam` state_dict for `model`'s
    parameters in `model.parameters()` order (the order of
    `make_optimizer`), for `optimizer.load_state_dict`.

    `opt_state` is that of `optax.adam` (a chain whose first element holds
    `count`, `mu` and `nu` as trees shaped like the params) or the Adam
    state itself. `mu` and `nu` map by the names of `state_dict_from_jax`
    to `exp_avg` and `exp_avg_sq`, `count` to `step`. The param group
    holds Adam's defaults with b1 0.9, b2 0.999, eps 1e-8; its learning
    rate is set from the schedule at every update
    (`TrainState.apply_gradients`)."""
    adam = opt_state if hasattr(opt_state, "mu") else \
        next(s for s in opt_state if hasattr(s, "mu"))
    num_layers, scales = model.encoder.num_layers, model.scales
    exp_avg = _monodepth(adam.mu, None, num_layers, scales)
    exp_avg_sq = _monodepth(adam.nu, None, num_layers, scales)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    names = [name for name, _ in model.named_parameters()]
    missing = set(names) ^ set(exp_avg)
    if missing:
        raise ValueError(f"optax state and model differ in {sorted(missing)[:5]}")
    template = torch.optim.Adam(model.parameters(), betas=(0.9, 0.999),
                                eps=1e-8).state_dict()
    return {"state": {i: {"step": step.clone(), "exp_avg": exp_avg[name],
                          "exp_avg_sq": exp_avg_sq[name]}
                      for i, name in enumerate(names)},
            "param_groups": template["param_groups"]}
