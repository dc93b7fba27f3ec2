"""Typed configuration + CLI, flag for flag the same as `monodepth_tpu`.

Every flag keeps its name and default, so one command line drives either
package. Some flags were written for the TPU build; here they mean:

- ``--use_pallas``: use the hand-written CUDA kernels
  (``ops/cuda/``). On a CPU tensor every kernel wrapper runs its plain
  PyTorch version instead. False selects the plain ``ops.sampling``
  ``grid_sample`` for the warp.
- ``--pallas_interpret`` and ``--nchw_decoder``: accepted and ignored
  (TPU layout and interpret controls with no counterpart here).
- ``--spatial_halo``: the rows each rank of a spatial mesh sends to each
  neighbour for its warps (capped at its own row count), as in JAX; a
  warp whose taps leave the slab falls back to an exact gathered warp.
- ``--remat``: as in JAX, both encoders recompute each residual block
  in the backward instead of keeping its activations
  (``torch.utils.checkpoint``; the recomputation does not update the
  batch-norm running statistics again), and the train step recomputes
  each warp, so the train-form warp kernel runs twice per warp.
- ``--donate``: accepted and ignored. The train step updates the
  parameters and the optimizer state in place, eagerly and in a CUDA
  graph alike (a graph keeps them at fixed addresses).
- ``--steps_per_call``: the Trainer runs that many train steps per call
  on consecutive batches (``training.step.make_train_multi_step``), equal
  to as many single steps. On one card the K steps are one CUDA graph,
  one replay a call, as JAX's ``lax.scan`` is one dispatch; a single step
  is a graph too, so K > 1 saves only the per-call host work (input
  copies, the noise draws, one replay). On the CPU and on a mesh the K
  steps run eagerly.
- ``--warp_guard`` and ``--warp_auto_swap``: accepted and ignored. In
  JAX they bound the Pallas warp's cost, which grows with the warp
  field's vertical span (a slab loop over the rows the taps reach). The
  CUDA train-form warp (K1) gathers each pixel's taps directly: at
  640x192 b12 on an H100 (700 W) it took 44.9 µs on a field whose 8-row
  slabs span 15 px, 55.4 at 39 px, 57.4 at 57 px and 62.0 µs on +-50 px
  noise (span 89 px), 1.38x the first (``chip_smoke.py`` phase 9f), so no
  regime calls for another sampler.
- ``--precision``: bf16 runs convolutions and batch norm in bf16 under
  ``torch.autocast``; the disparity heads, the pose average and the loss
  stack stay f32. Parameters are always f32.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence, Tuple, Union

FrameId = Union[int, str]  # ints for temporal frames, "s" for the stereo frame


@dataclasses.dataclass(frozen=True)
class Config:
    # --- paths / dataset ---
    datapath: str = "./dataset/kitti"
    splits: str = "./splits"
    dataset: str = "kitti_mono"          # kitti_mono | kitti_stereo
    datatype: str = "kitti_eigen_zhou"   # kitti_benchmark | kitti_eigen_full | kitti_eigen_zhou

    # --- schedule ---
    epoch: int = 24
    batch: int = 12                      # global batch
    prefetch: int = 2
    num_workers: int = 12
    learning_rate: float = 1e-4
    scheduler_step: int = 15
    disp_smoothness: float = 1e-3
    save: str = "test"

    # --- geometry ---
    height: int = 192
    width: int = 640
    scales: Tuple[int, ...] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    frame_ids: Tuple[FrameId, ...] = (0, -1, 1)
    pose_frames: Union[int, str] = 2     # 2 | "all"

    # --- model ---
    num_layers: int = 18                 # 18 | 34 | 50 | 101 | 152
    weight_init: bool = True             # ImageNet init from a converted checkpoint
    pose_type: str = "separate"          # posecnn | shared | separate
    use_automasking: bool = True

    # --- extras (module docstring says which are ignored here) ---
    pretrained_dir: str = "./pretrained"
    precision: str = "bf16"              # bf16 | f32 compute dtype (params always f32)
    data_parallel: int = 0               # 0 = use all local devices
    seed: int = 42
    log_every: int = 50
    ckpt_every: int = 2
    ckpt_keep: int = 3
    async_ckpt: bool = False
    resume: bool = False
    profile_dir: str = ""
    save_root: str = "./model_save"
    use_pallas: bool = True              # use the hand-written CUDA kernels
    nchw_decoder: bool = True            # ignored
    warp_guard: bool = False             # ignored (module docstring)
    warp_auto_swap: bool = True          # ignored (module docstring)
    warp_telemetry: bool = False         # internal (no CLI flag): report warp_span
                                         # even when the kernels are off
    pallas_interpret: bool = False       # ignored
    train_gt_metrics: bool = False
    remat: bool = False                  # recompute encoder blocks and warps
    donate: bool = False                 # ignored
    steps_per_call: int = 1              # train steps per call of the Trainer
    cache_frames: bool = False
    spatial_halo: int = 64               # halo rows of a spatial mesh's warps
    eigen_every: int = 0

    @property
    def num_pose_frames(self) -> int:
        if self.pose_frames == "all":
            return len([f for f in self.frame_ids if f != "s"])
        return 2

    @property
    def temporal_frame_ids(self) -> Tuple[int, ...]:
        return tuple(f for f in self.frame_ids if f != "s")

    @property
    def source_frame_ids(self) -> Tuple[FrameId, ...]:
        return tuple(self.frame_ids[1:])

    @property
    def num_scales(self) -> int:
        return len(self.scales)

    def validate(self) -> "Config":
        cfg = self
        if cfg.dataset == "kitti_stereo" and "s" not in cfg.frame_ids:
            cfg = dataclasses.replace(cfg, frame_ids=cfg.frame_ids + ("s",))
        if cfg.height % 32 or cfg.width % 32:
            raise ValueError("height/width must be multiples of 32 (reference: kitti_mono.py:264)")
        if cfg.frame_ids[0] != 0:
            raise ValueError("frame_ids must start with the key frame 0")
        if 0 not in cfg.scales:
            raise ValueError("scales must include 0 (the full-res output "
                             "every eval/metric path consumes)")
        if cfg.pose_type not in ("posecnn", "shared", "separate"):
            raise ValueError(f"unknown pose_type {cfg.pose_type!r}")
        if cfg.dataset not in ("kitti_mono", "kitti_stereo"):
            raise ValueError(f"unknown dataset {cfg.dataset!r}")
        if cfg.steps_per_call < 1:
            raise ValueError("steps_per_call must be >= 1")
        if cfg.data_parallel < 0:
            raise ValueError("data_parallel must be >= 0 (0 = all devices)")
        if cfg.precision not in ("bf16", "f32"):
            raise ValueError(f"unknown precision {cfg.precision!r}")
        return cfg


def _parse_frame_ids(text: str) -> Tuple[FrameId, ...]:
    return tuple(t if t == "s" else int(t)
                 for t in text.replace(",", " ").split())


def _parse_scales(text: str) -> Tuple[int, ...]:
    return tuple(int(t) for t in text.replace(",", " ").split())


def _parse_bool(text: str) -> bool:
    return str(text).lower() in ("1", "true", "yes", "y")


def _parse_pose_frames(text: str) -> Union[int, str]:
    return "all" if text == "all" else int(text)


def options(argv: Sequence[str] | None = None) -> Config:
    """argparse front-end; every flag keeps its name and default."""
    d = Config()
    p = argparse.ArgumentParser(description="monodepth_tpu_torch options")
    p.add_argument("--datapath", default=d.datapath, type=str)
    p.add_argument("--splits", default=d.splits, type=str)
    p.add_argument("--dataset", default=d.dataset, type=str,
                   choices=["kitti_mono", "kitti_stereo"])
    p.add_argument("--datatype", default=d.datatype, type=str,
                   choices=["kitti_benchmark", "kitti_eigen_full", "kitti_eigen_zhou"])
    p.add_argument("--epoch", default=d.epoch, type=int)
    p.add_argument("--batch", default=d.batch, type=int)
    p.add_argument("--prepetch", "--prefetch", dest="prefetch", default=d.prefetch, type=int)
    p.add_argument("--num_workers", default=d.num_workers, type=int)
    p.add_argument("--learning_rate", default=d.learning_rate, type=float)
    p.add_argument("--scheduler_step", default=d.scheduler_step, type=int)
    p.add_argument("--disp_smoothness", default=d.disp_smoothness, type=float)
    p.add_argument("--save", default=d.save, type=str)
    p.add_argument("--height", default=d.height, type=int)
    p.add_argument("--width", default=d.width, type=int)
    p.add_argument("--scales", default=d.scales, type=_parse_scales)
    p.add_argument("--min_depth", default=d.min_depth, type=float)
    p.add_argument("--max_depth", default=d.max_depth, type=float)
    p.add_argument("--frame_ids", default=d.frame_ids, type=_parse_frame_ids)
    p.add_argument("--pose_frames", default=d.pose_frames, type=_parse_pose_frames)
    p.add_argument("--num_layers", default=d.num_layers, type=int,
                   choices=[18, 34, 50, 101, 152])
    p.add_argument("--weight_init", default=d.weight_init, type=_parse_bool)
    p.add_argument("--pose_type", default=d.pose_type, type=str,
                   choices=["posecnn", "shared", "separate"])
    p.add_argument("--use_automasking", default=d.use_automasking, type=_parse_bool)
    p.add_argument("--pretrained_dir", default=d.pretrained_dir, type=str)
    p.add_argument("--precision", default=d.precision, type=str, choices=["bf16", "f32"])
    p.add_argument("--data_parallel", default=d.data_parallel, type=int)
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--log_every", default=d.log_every, type=int)
    p.add_argument("--ckpt_every", default=d.ckpt_every, type=int)
    p.add_argument("--ckpt_keep", default=d.ckpt_keep, type=int)
    p.add_argument("--async_ckpt", default=d.async_ckpt, type=_parse_bool)
    p.add_argument("--resume", default=d.resume, type=_parse_bool)
    p.add_argument("--profile_dir", default=d.profile_dir, type=str)
    p.add_argument("--save_root", default=d.save_root, type=str)
    p.add_argument("--use_pallas", default=d.use_pallas, type=_parse_bool)
    p.add_argument("--nchw_decoder", default=d.nchw_decoder, type=_parse_bool)
    p.add_argument("--warp_guard", default=d.warp_guard, type=_parse_bool)
    p.add_argument("--warp_auto_swap", default=d.warp_auto_swap,
                   type=_parse_bool)
    p.add_argument("--pallas_interpret", default=d.pallas_interpret, type=_parse_bool)
    p.add_argument("--train_gt_metrics", default=d.train_gt_metrics, type=_parse_bool)
    p.add_argument("--remat", default=d.remat, type=_parse_bool)
    p.add_argument("--donate", default=d.donate, type=_parse_bool)
    p.add_argument("--steps_per_call", default=d.steps_per_call, type=int)
    p.add_argument("--cache_frames", default=d.cache_frames, type=_parse_bool)
    p.add_argument("--spatial_halo", default=d.spatial_halo, type=int)
    p.add_argument("--eigen_every", default=d.eigen_every, type=int)
    args = p.parse_args(argv)
    return Config(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Config)
                     if hasattr(args, f.name)}).validate()
