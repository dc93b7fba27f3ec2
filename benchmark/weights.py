"""The seeded weights both sides load: made on the device from the run's
seed, in one draw for all convolution weights, in float32.

No ImageNet checkpoint is in the repository, so each convolution weight
starts from its family reference's `fan_init_std` (Monodepth2's: the
encoders from torchvision's ResNet init, He normal over fan-out, the
decoders from LeCun normal over fan-in); biases are zero and batch norm
is the identity. The names and shapes are the family reference's model's.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict

import torch

Tensor = torch.Tensor


def seeded_state_dict(family: ModuleType, cfg: dict, g: torch.Generator,
                      device) -> Dict[str, Tensor]:
    reference = family.reference
    shapes = {k: tuple(v.shape) for k, v in
              reference.build(cfg, device="meta").state_dict().items()}
    convs = [k for k, s in shapes.items() if k.endswith("weight") and len(s) == 4]
    draw = torch.randn(sum(math.prod(shapes[k]) for k in convs), generator=g,
                       device=device)
    out, start = {}, 0
    for k in convs:
        size = math.prod(shapes[k])
        out[k] = draw[start:start + size].view(shapes[k]) * reference.fan_init_std(k, shapes[k])
        start += size
    for k, s in shapes.items():
        if k in out:
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(("running_var", "weight")):      # batch norm
            out[k] = torch.ones(s, device=device)
        else:                                            # biases, running means
            out[k] = torch.zeros(s, device=device)
    return out

