"""The port's `Monodepth` state_dict -> the JAX `Monodepth` variables
(numpy only), for the per-module npz exports that both packages' eval
CLIs read.

The inverse of `utils/jax_import.py`, through this package's copy of
the official-layout converters (`utils/torch_import.py`), for every pose
wiring: the encoders as torchvision ResNets (the pose encoder's
3·num_pose_frames-channel conv1 as it is), the depth decoder in the
official Monodepth2 order, the pose decoder as `pose.pth` or, where the
state_dict has `pose_decoder.pose_conv`, as a PoseCNN checkpoint. The
0-d `num_batches_tracked` counters have no JAX counterpart and are left
out.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from monodepth_tpu_torch.utils.torch_import import (
    depth_decoder_params,
    pose_cnn_params,
    pose_decoder_params,
    resnet_encoder_variables,
)


def _sub(state_dict: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def jax_variables(state_dict: Mapping[str, Any], num_layers: int,
                  scales) -> Dict[str, Any]:
    """{"params": {module: tree}, "batch_stats": {encoder[, pose_encoder]}}
    of the JAX `Monodepth` of the state_dict's wiring (`pose_encoder` only
    for `separate`), as numpy arrays (f64 stays f64, anything else becomes
    f32)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items() if v.ndim >= 1}
    enc = resnet_encoder_variables(_sub(sd, "encoder."), num_layers)
    pose = _sub(sd, "pose_decoder.")
    params = {"encoder": enc["params"],
              "decoder": depth_decoder_params(_sub(sd, "decoder."), scales),
              "pose_decoder": (pose_cnn_params(pose) if "pose_conv.weight" in pose
                               else pose_decoder_params(pose))}
    stats = {"encoder": enc["batch_stats"]}
    if "pose_encoder.conv1.weight" in sd:
        penc = resnet_encoder_variables(
            _sub(sd, "pose_encoder."), num_layers,
            num_input_images=sd["pose_encoder.conv1.weight"].shape[1] // 3)
        params["pose_encoder"], stats["pose_encoder"] = penc["params"], penc["batch_stats"]
    return {"params": params, "batch_stats": stats}
