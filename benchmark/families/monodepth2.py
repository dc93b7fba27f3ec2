"""Monodepth2 (github.com/nianticlabs/monodepth2): ResNet depth and
`separate` pose networks over frame pairs, frames 0, -1, 1 and the
stereo frame "s". The program's side is the port's `Monodepth` with its
`create_state` and `make_train_step`; the reference is
`benchmark/reference.py`; the inputs are `scenes.planar_scenes`; the
counts are `benchmark/counts.py`. The contract: `families/__init__.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import counts, reference, scenes

Tensor = torch.Tensor

NETWORKS = ("encoder.", "decoder.", "pose_encoder.", "pose_decoder.")
train_step_flops = counts.train_step_flops
warp_train_bytes = counts.warp_train_bytes


def config(conf: dict):
    """The port's `Config` of a configuration's fields."""
    from monodepth_tpu_torch.config import Config

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in conf.items()}
    return Config(**fields).validate()


def inputs(conf: dict, traffic: dict, seed: int, n: int,
           device) -> Tuple[List[Dict[str, Tensor]], List[Dict[int, Tensor]]]:
    """The ring of planar scenes, `n` items a batch, frames in the order
    of `frame_ids`, and each step's automask tie noise."""
    H, W = conf["height"], conf["width"]
    frame_ids = tuple(conf["frame_ids"])
    baseline = None
    if "s" in frame_ids:
        baseline = scenes.stereo_baselines(scenes.generator(seed, 3, device),
                                           traffic["ring"] * n, device)
    ring = scenes.planar_scenes(scenes.generator(seed, 1, device), traffic["ring"] * n,
                                H, W, traffic["max_shift_px"], traffic["texture_cell"],
                                device, frame_ids, baseline)
    batches = [{k: v[i * n:(i + 1) * n] for k, v in ring.items()}
               for i in range(traffic["ring"])]
    g = scenes.generator(seed, 2, device)
    noises = [scenes.tie_noise(g, n, H, W, len(frame_ids) - 1, conf["scales"], device)
              for _ in range(traffic["ring"])]
    return batches, noises


def port(conf: dict, state_dict: Dict[str, Tensor], device, mesh, steps_per_epoch: int):
    """The port's train step with its model and Adam state."""
    from monodepth_tpu_torch.models.monodepth import Monodepth
    from monodepth_tpu_torch.parallel.mesh import replicate
    from monodepth_tpu_torch.training.state import create_state, set_precision
    from monodepth_tpu_torch.training.step import make_train_step

    cfg = config(conf)
    set_precision(cfg)
    with torch.device(device):
        model = Monodepth(num_layers=cfg.num_layers, scales=cfg.scales,
                          frame_ids=cfg.frame_ids, pose_type=cfg.pose_type,
                          pose_frames=cfg.pose_frames, remat=cfg.remat)
    model.load_state_dict(state_dict)
    state = create_state(cfg, model, steps_per_epoch=steps_per_epoch)
    if mesh is not None:
        replicate(mesh, state)
    return state, make_train_step(model, cfg, device=device, mesh=mesh)


def disparity_module(model):
    return model.decoder
