"""Shared helpers of the tests that hold `monodepth_tpu_torch` against
`monodepth_tpu`: random batch-norm statistics, the port's state_dict (or
its gradients) as the JAX `Monodepth` variables, the tie-break noise of
the JAX eval and train steps, and the `one_thread` fixture."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from monodepth_tpu.utils import torch_import


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op torch thread for a test module (`pytestmark =
    pytest.mark.usefixtures("one_thread")`, with this fixture imported):
    the shapes are tiny, and beside the other test workers on the host more
    threads only oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize_bn_stats(model: torch.nn.Module, seed: int = 0) -> None:
    """Non-trivial eval-mode batch norm: random means, positive variances."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
            m.weight.data.copy_(1.0 + 0.1 * torch.randn(m.num_features, generator=g))
            m.bias.data.copy_(0.1 * torch.randn(m.num_features, generator=g))


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def flax_variables(state_dict, cfg):
    """The port's `Monodepth` state_dict -> the JAX `Monodepth` variables of
    `cfg`'s pose wiring, through `monodepth_tpu.utils.torch_import`: the
    pose decoder as PoseCNN for `posecnn`, the pose encoder (of
    `cfg.num_pose_frames` images) for `separate` only."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()
          if v.ndim >= 1}
    enc = torch_import.resnet_encoder_variables(
        _sub(sd, "encoder."), cfg.num_layers)
    pose = _sub(sd, "pose_decoder.")
    params = {
        "encoder": enc["params"],
        "decoder": torch_import.depth_decoder_params(
            _sub(sd, "decoder."), cfg.scales),
        "pose_decoder": (torch_import.pose_cnn_params(pose)
                         if cfg.pose_type == "posecnn"
                         else torch_import.pose_decoder_params(pose)),
    }
    stats = {"encoder": enc["batch_stats"]}
    if cfg.pose_type == "separate":
        penc = torch_import.resnet_encoder_variables(
            _sub(sd, "pose_encoder."), cfg.num_layers,
            num_input_images=cfg.num_pose_frames)
        params["pose_encoder"] = penc["params"]
        stats["pose_encoder"] = penc["batch_stats"]
    return {"params": params, "batch_stats": stats}


def grads_as_flax(model: torch.nn.Module, cfg):
    """The port's parameter gradients as the JAX `Monodepth` params tree."""
    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    return flax_variables(sd, cfg)["params"]


def _scale_noise(rng, cfg, dtype):
    """One split per scale from `rng` (losses/reprojection.py)."""
    import jax

    shape = (cfg.batch, cfg.height, cfg.width, len(cfg.source_frame_ids))
    out = {}
    for s in cfg.scales:
        rng, sub = jax.random.split(rng)
        out[s] = torch.from_numpy(
            1e-5 * np.asarray(jax.random.normal(sub, shape, dtype)))
    return out


def eval_noise(state_rng, step: int, index: int, cfg):
    """The per-scale tie-break noise the JAX eval step draws for batch
    `index` at `step`: fold_in(fold_in(rng, step), index), then one split
    per scale (training/step.py eval_step, losses/reprojection.py)."""
    import jax

    rng = jax.random.fold_in(jax.random.fold_in(state_rng, step), index)
    return _scale_noise(rng, cfg, np.float32)


def train_noise(state_rng, step: int, cfg, dtype=np.float32):
    """The per-scale tie-break noise the JAX train step draws at `step`:
    fold_in(rng, step), then one split per scale (training/step.py
    `_train_step_body`). An f64 `dtype` needs jax's x64 mode on."""
    import jax

    return _scale_noise(jax.random.fold_in(state_rng, step), cfg, dtype)
