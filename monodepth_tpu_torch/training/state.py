"""Model construction, the optimizer and the state the steps carry.

Counterpart of `monodepth_tpu.training.state`: `build_model` makes the
seeded `Monodepth` on its device; `make_optimizer` is Adam under the
reference's StepLR decay (reference: model_tool/loader.py:106-108,
model_train.py:81) with the learning rate a function of the global step;
`TrainState` holds the model, the global step, the seed that keys the
loss noise and, for training, the optimizer and its schedule. The model
and the optimizer are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.models.monodepth import Monodepth

MODULES = ("encoder", "decoder", "pose_encoder", "pose_decoder")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. Raises when a CUDA device is asked for and none is
    present: there is no silent fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def set_precision(cfg: Config) -> None:
    """Set PyTorch's process-wide TF32 switches from --precision.

    Matrix products (geometry, resizes) always run in full f32, as the
    JAX package runs them at precision="highest". f32 convolutions use
    TF32 only under bf16, where the convolutions run in bf16 anyway."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = cfg.precision == "bf16"


def build_model(cfg: Config, device=None) -> Monodepth:
    """The configured `Monodepth`, initialized from `cfg.seed`, in eval
    mode on `device` (default: the card). Parameters are f32 whatever
    the precision. `cfg.weight_init` is read by the Trainer, which loads
    the ImageNet encoder into this model (`training.loop.load_pretrained`)."""
    device = resolve_device(device)
    set_precision(cfg)
    model = Monodepth(num_layers=cfg.num_layers, scales=cfg.scales,
                      frame_ids=cfg.frame_ids, pose_type=cfg.pose_type,
                      pose_frames=cfg.pose_frames, remat=cfg.remat)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    return model.to(device).eval()


def copy_into(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy `tensors` (state_dict names, any subset) into `model`'s
    parameters and buffers, on their device and in their dtype. Raises on
    a name the model lacks or a shape that differs."""
    own = model.state_dict()
    unknown = sorted(set(tensors) - set(own))
    if unknown:
        raise ValueError(f"weights hold entries the model lacks: {unknown[:5]}")
    with torch.no_grad():
        for key, value in tensors.items():
            if own[key].shape != value.shape:
                raise ValueError(f"{key}: weights {tuple(value.shape)}, "
                                 f"model {tuple(own[key].shape)}")
            own[key].copy_(value)


def module_grads(model: Monodepth) -> Dict[str, torch.Tensor]:
    """{top-level module (`MODULES`): its parameters' gradients, flattened,
    f64}, for comparing the gradients of two steps module by module."""
    return {m: torch.cat([p.grad.detach().double().flatten()
                          for n, p in model.named_parameters()
                          if n.split(".")[0] == m]) for m in MODULES}


Schedule = Callable[[int], float]


def step_decay_schedule(base_lr: float, scheduler_step: int,
                        steps_per_epoch: int, gamma: float = 0.1) -> Schedule:
    """lr(step) = base · gamma^((step // steps_per_epoch) // scheduler_step):
    StepLR with the epoch boundary folded into the global step."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * gamma ** (epoch // scheduler_step)

    return schedule


def make_optimizer(cfg: Config, model: Monodepth, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam, Schedule]:
    """Adam(b1=0.9, b2=0.999, eps=1e-8) over the model's parameters and
    its StepLR schedule. `TrainState.apply_gradients` sets the learning
    rate of step k to schedule(k) before the update, as optax counts."""
    schedule = step_decay_schedule(cfg.learning_rate, cfg.scheduler_step,
                                   steps_per_epoch)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return optimizer, schedule


@dataclasses.dataclass
class TrainState:
    """The module with its global step, the seed of the loss noise and,
    for training, the optimizer and its learning-rate schedule."""

    model: Monodepth
    step: int = 0
    seed: int = 42
    optimizer: Optional[torch.optim.Optimizer] = None
    schedule: Optional[Schedule] = None

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in the parameters'
        `.grad`, at the learning rate schedule(step); then step += 1."""
        if self.optimizer is None:
            raise ValueError("this state has no optimizer: build it with "
                             "create_state(cfg, model, steps_per_epoch=...)")
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_state(cfg: Config, model: Monodepth,
                 steps_per_epoch: int | None = None) -> TrainState:
    """The state at step 0. With `steps_per_epoch` it also holds Adam and
    the StepLR schedule (`make_optimizer`); without, it serves the eval
    and infer steps only."""
    state = TrainState(model=model, step=0, seed=cfg.seed)
    if steps_per_epoch is not None:
        state.optimizer, state.schedule = make_optimizer(cfg, model,
                                                         steps_per_epoch)
    return state
