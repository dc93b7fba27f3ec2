"""The port's `Monodepth` state_dict -> the JAX `Monodepth` variables
(numpy only), for the per-module npz exports that both packages' eval
CLIs read.

The inverse of `utils/jax_import.py`, through this package's copy of
the official-layout converters (`utils/torch_import.py`): the encoders
as torchvision ResNets (the pose encoder's 6-channel conv1 as it is),
the depth decoder in the official Monodepth2 order, the pose decoder as
`pose.pth`. The 0-d `num_batches_tracked` counters have no JAX
counterpart and are left out.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from monodepth_tpu_torch.utils.torch_import import (
    depth_decoder_params,
    pose_decoder_params,
    resnet_encoder_variables,
)


def _sub(state_dict: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def jax_variables(state_dict: Mapping[str, Any], num_layers: int,
                  scales) -> Dict[str, Any]:
    """{"params": {module: tree}, "batch_stats": {encoder, pose_encoder}}
    of the JAX `Monodepth` (separate wiring), as numpy arrays (f64 stays
    f64, anything else becomes f32)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items() if v.ndim >= 1}
    enc = resnet_encoder_variables(_sub(sd, "encoder."), num_layers)
    penc = resnet_encoder_variables(_sub(sd, "pose_encoder."), num_layers,
                                    num_input_images=2)
    return {
        "params": {
            "encoder": enc["params"],
            "decoder": depth_decoder_params(_sub(sd, "decoder."), scales),
            "pose_encoder": penc["params"],
            "pose_decoder": pose_decoder_params(_sub(sd, "pose_decoder.")),
        },
        "batch_stats": {"encoder": enc["batch_stats"],
                        "pose_encoder": penc["batch_stats"]},
    }
