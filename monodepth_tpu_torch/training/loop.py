"""The training orchestrator: data, state, epoch loop, logging, checkpoints.

Counterpart of `monodepth_tpu.training.loop` (reference: model_train.py
:25-97, model_tool/loader.py:16-118, model_tool/logger.py:16-72), on one
device (the card unless the caller names another), or on a process mesh
when the process group holds more than one process (`init_distributed`,
as `python -m monodepth_tpu_torch.model_train` does under torchrun):

- the mesh is data-parallel over every process, as JAX's Trainer mesh:
  each rank's `Loader` loads its contiguous slice of every global batch,
  the state is replicated from rank 0, and the mesh steps average the
  gradients and normalize batch norm over the global batch;
- the batches of `Loader` go through `prefetch_to_device`, so the copies
  to the card overlap the step that runs; a step's wait for its batch is
  the `torch.profiler` range "trainer/wait_data" (`--profile_dir`);
- on one card, and on a mesh over NCCL (one rank a card), the train,
  validation and Eigen-infer calls are CUDA graphs (`training.step`,
  `graph=None`): each copies its batch into the graph's static inputs on
  the consuming stream and replays; the first call of each shape runs
  eagerly and the second captures, after any pretrained load and
  restore. On a mesh the graphs hold the synced batch norm, the gradient
  all-reduce and the metric reductions. Over gloo (ranks sharing a card,
  or the CPU) every step runs eagerly: gloo's collectives run on host
  tensors;
- the metrics accumulate on the device and are fetched once per flush
  (`_Meter`), not once per step;
- each epoch prints the reference's 8-metric table, appends a record to
  `metrics.jsonl` and, at the end, the curves are saved as .npy per split;
- a full-state checkpoint every `ckpt_every` epochs, at the last epoch and
  on SIGTERM or SIGINT (on any rank: the ranks agree at the epoch's end),
  with `--resume`; module exports in the JAX package's npz layout; rank 0
  alone writes files and prints.

`--warp_guard` and `--warp_auto_swap` are accepted and ignored (see
`config.py`); `warp_span` and `warp_span_max` still go to `metrics.jsonl`.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import signal
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data.dataset import KittiDataset
from monodepth_tpu_torch.data.kitti import readlines
from monodepth_tpu_torch.data.pipeline import Loader, prefetch_to_device
from monodepth_tpu_torch.evaluation import eigen
from monodepth_tpu_torch.losses.metrics import METRIC_NAMES
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.parallel.mesh import agree_max, make_mesh, replicate, warm_collectives
from monodepth_tpu_torch.training.checkpoint import Checkpointer
from monodepth_tpu_torch.training.state import (
    build_model,
    copy_into,
    create_state,
    step_decay_schedule,
)
from monodepth_tpu_torch.training.step import (
    make_eval_step,
    make_infer_step,
    make_train_multi_step,
    make_train_step,
)
from monodepth_tpu_torch.utils.jax_import import module_state_dict
from monodepth_tpu_torch.utils.serialization import load_npz
from monodepth_tpu_torch.utils.torch_import import load_torch_file

LOG_METRICS = ("loss",) + METRIC_NAMES  # reference: logger.py:27


def load_pretrained(cfg: Config, model: Monodepth) -> Optional[str]:
    """Load ImageNet weights into the encoder(s) of `model` in place
    (`--weight_init`; reference: depth_encoder.py:44-62). Reads
    `resnet<N>.npz` (the JAX package's layout) or a torchvision
    `resnet<N>.pth` (its `fc.*` dropped) from `cfg.pretrained_dir`. For
    the `separate` pose wiring the pose encoder gets the same weights with
    conv1 tiled over its `num_pose_frames` input images and divided by
    their count (depth_encoder.py:59); `shared` and `posecnn` have no pose
    encoder, and no pose net loads pretrained weights (JAX's
    `load_pretrained`). Returns the path read, or None (weight_init off,
    or no file: the random init stays, with a message)."""
    if not cfg.weight_init:
        return None
    base = os.path.join(cfg.pretrained_dir, f"resnet{cfg.num_layers}")
    if os.path.exists(base + ".npz"):
        path = base + ".npz"
        tree = load_npz(path)
        named = module_state_dict("encoder", tree["params"], tree.get("batch_stats"),
                                  cfg.num_layers, cfg.scales)
        weights = {k[len("encoder."):]: v for k, v in named.items()}
    elif os.path.exists(base + ".pth"):
        path = base + ".pth"
        sd = load_torch_file(path)
        if any(k.startswith("encoder.") for k in sd):  # Monodepth2 encoder.pth
            sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
        weights = {k: torch.as_tensor(v) for k, v in sd.items() if not k.startswith("fc.")}
    else:
        print(f">>> no pretrained resnet{cfg.num_layers} under "
              f"{cfg.pretrained_dir}; using random init")
        return None
    copy_into(model, {f"encoder.{k}": v for k, v in weights.items()})
    if cfg.pose_type == "separate":
        n = cfg.num_pose_frames
        pose = dict(weights, **{"conv1.weight": torch.cat([weights["conv1.weight"]] * n, 1) / n})
        copy_into(model, {f"pose_encoder.{k}": v for k, v in pose.items()})
    return path


# Metrics whose epoch MAX matters, not just the mean: a cumulative mean
# dilutes late-epoch divergence, so these also get a running max
# (reported as "<key>_max").
_MAX_KEYS = ("warp_span",)


def _waited(batches):
    """`batches`, each taken inside the range "trainer/wait_data"."""
    batches = iter(batches)
    while True:
        with record_function("trainer/wait_data"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


class _Meter:
    """Running sums (and maxes for `_MAX_KEYS`) kept on the device; one
    host fetch per flush. A metric is a 0-d tensor, or a [K] tensor from
    `make_train_multi_step`, whose values are added one by one in step
    order, so the sums equal those of K single steps. The first value of
    a key is copied, so a caller may reuse its tensor afterwards."""

    def __init__(self):
        self.sums: Dict[str, torch.Tensor] = {}
        self.maxes: Dict[str, torch.Tensor] = {}
        self.count = 0

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        k = 1
        for key, value in metrics.items():
            values = value.unbind(0) if value.ndim else (value,)
            k = len(values)
            for v in values:
                self.sums[key] = v.clone() if key not in self.sums \
                    else self.sums[key] + v
                if key in _MAX_KEYS:
                    self.maxes[key] = v.clone() if key not in self.maxes \
                        else torch.maximum(self.maxes[key], v)
        self.count += k

    def means(self) -> Dict[str, float]:
        if not self.count:
            return {k: float("nan") for k in LOG_METRICS}
        keys, max_keys = list(self.sums), list(self.maxes)
        host = torch.stack([self.sums[k].double() for k in keys]
                           + [self.maxes[k].double() for k in max_keys]).cpu().tolist()
        out = {k: v / self.count for k, v in zip(keys, host)}
        out.update({k + "_max": v for k, v in zip(max_keys, host[len(keys):])})
        return out


class Trainer:
    """`Trainer(options()).train()`, the reference's entry contract
    (model_train.py:100-101): `device` defaults to the card (in a process
    group, the card `init_distributed` made current). The mesh is
    {data: every process}: `--data_parallel` is 0 or the group's size.
    `train_files` and `valid_files` default to the split's lists."""

    def __init__(self, cfg: Config, device=None,
                 train_files: Sequence[str] | None = None,
                 valid_files: Sequence[str] | None = None):
        self.cfg = cfg = cfg.validate()
        world = dist.get_world_size() if dist.is_initialized() else 1
        if cfg.data_parallel not in (0, world):
            raise ValueError(
                f"--data_parallel {cfg.data_parallel}: the Trainer's mesh covers "
                f"every process of the group ({world}); pass 0 or {world}")
        self.mesh = make_mesh(cfg.data_parallel or world, 1, device)
        self.device = self.mesh.device
        self.main = self.mesh.rank == 0  # prints and writes
        warm_collectives(self.mesh)
        # the batch splits over the data axis
        if cfg.batch % self.mesh.data:
            raise ValueError(f"global batch {cfg.batch} not divisible by the "
                             f"mesh's data axis ({self.mesh.data})")
        step_mesh = self.mesh if self.mesh.size > 1 else None

        split_dir = os.path.join(cfg.splits, cfg.datatype)
        if train_files is None:
            train_files = readlines(os.path.join(split_dir, "train_files.txt"))
        if valid_files is None:
            valid_files = readlines(os.path.join(split_dir, "val_files.txt"))

        gt_cache = os.path.join(cfg.save_root, "gt_cache")
        frame_cache = (os.path.join(cfg.save_root, "frame_cache")
                       if cfg.cache_frames else None)
        ds_args = dict(datapath=cfg.datapath, frame_ids=cfg.frame_ids,
                       height=cfg.height, width=cfg.width,
                       gt_cache_dir=gt_cache, frame_cache_dir=frame_cache)
        # without in-step GT metrics the train pass needs no depth map (the
        # valid pass always loads GT for its metric table)
        self.train_dataset = KittiDataset(filenames=train_files, is_training=True,
                                          load_depth=cfg.train_gt_metrics, **ds_args)
        self.valid_dataset = KittiDataset(filenames=valid_files, is_training=False,
                                          **ds_args)
        loader_args = dict(batch_size=cfg.batch, num_workers=cfg.num_workers,
                           seed=cfg.seed, drop_last=True,
                           prefetch_batches=cfg.prefetch,
                           process_index=self.mesh.data_index,
                           process_count=self.mesh.data)
        self.train_loader = Loader(self.train_dataset, shuffle=True, **loader_args)
        self.valid_loader = Loader(self.valid_dataset, shuffle=False, **loader_args)

        self.model = build_model(cfg, self.device)
        load_pretrained(cfg, self.model)
        self.state = create_state(cfg, self.model,
                                  steps_per_epoch=len(self.train_loader))
        replicate(self.mesh, self.state)
        make = make_train_multi_step if cfg.steps_per_call > 1 else make_train_step
        self.train_step = make(self.model, cfg, self.device, mesh=step_mesh)
        self.eval_step = make_eval_step(self.model, cfg, self.device, mesh=step_mesh)

        self.save_dir = os.path.join(cfg.save_root, cfg.save)
        self.checkpointer = Checkpointer(self.save_dir, keep=cfg.ckpt_keep,
                                         async_save=cfg.async_ckpt)
        self.start_epoch = 0
        if cfg.resume and self.checkpointer.latest_epoch() is not None:
            _, restored = self.checkpointer.restore(self.state)
            replicate(self.mesh, self.state)
            self.start_epoch = restored + 1
            self._log(f">>> resumed from epoch {restored}")

        self.history = {split: {k: [] for k in LOG_METRICS}
                        for split in ("train", "valid")}
        if self.start_epoch:
            self._load_curves()  # keep curves continuous across resume

        self._eigen = None  # (test lines, ground truths), loaded once
        self._eigen_infer = None

    def _log(self, *args) -> None:
        if self.main:
            print(*args)

    def close(self) -> None:
        """Shut down the loaders' thread pools (`train` does at its end)."""
        self.train_loader.close()
        self.valid_loader.close()

    # ------------------------------------------------------------------
    def eigen_eval(self) -> Dict[str, float]:
        """The full Eigen test protocol (`evaluation/eigen.py`) on the
        current model (`--eigen_every N`). The test lines and their
        projected velodyne GT load once and stay cached for the run. On a
        mesh each rank sweeps its `process_slice` of the split and
        `evaluate_multihost` combines the error sums: the same metrics. A
        rank that fails before the sweep still joins its all-gather (its
        peers wait in it), and then every rank raises."""
        cfg = self.cfg
        multi = self.mesh.size > 1
        failure = None
        try:
            if self._eigen is None:
                lines = readlines(os.path.join(cfg.splits, cfg.datatype,
                                               "test_files.txt"))
                if multi:
                    lines = eigen.process_slice(lines)
                gts = eigen.load_ground_truth(
                    cfg.datapath, lines,
                    cache_dir=os.path.join(cfg.save_root, "gt_cache_eval"))
                self._eigen = (lines, gts)
            if self._eigen_infer is None:  # a CUDA graph on a card, but over gloo
                gloo = multi and self.mesh.backend != "nccl"
                self._eigen_infer = make_infer_step(self.model, cfg, self.device,
                                                    graph=False if gloo else None)
        except Exception as exc:  # noqa: BLE001 - a rank must reach the all-gather
            if not multi:
                raise
            failure = exc
        lines, gts = self._eigen if self._eigen is not None else ([], [])
        if multi:
            return eigen.evaluate_multihost(cfg, self.model, lines, gts,
                                            eval_batch=max(cfg.batch, 1),
                                            num_workers=cfg.num_workers,
                                            infer=self._eigen_infer, failure=failure)
        disps = eigen.predict_disparities(cfg, self.model, lines,
                                          eval_batch=max(cfg.batch, 1),
                                          num_workers=cfg.num_workers,
                                          infer=self._eigen_infer)
        return eigen.eigen_metrics(disps, gts, cfg.datatype)

    # ------------------------------------------------------------------
    def _epoch(self, epoch: int, training: bool) -> Dict[str, float]:
        cfg = self.cfg
        loader = self.train_loader if training else self.valid_loader
        meter = _Meter()
        t0 = time.perf_counter()
        images = 0

        K = cfg.steps_per_call if training else 1
        batches = _waited(prefetch_to_device(loader.epoch(epoch), cfg.prefetch,
                                             self.device))
        if K > 1:
            # K consecutive batches a call; a trailing partial group is
            # dropped, as JAX's superbatches drop it (fixed shapes)
            batches = (g for g in itertools.batched(batches, K) if len(g) == K)
        for step, batch in enumerate(batches):
            if training:
                metrics = self.train_step(self.state, batch)
            else:
                metrics = self.eval_step(self.state, batch, step)  # per-batch noise
            meter.update(metrics)
            images += cfg.batch * K
            if training and cfg.log_every and (step + 1) % cfg.log_every == 0:
                dt = time.perf_counter() - t0
                means = meter.means()
                self._log(f"    epoch {epoch} step {(step + 1) * K}/{len(loader)} "
                          f"loss {means['loss']:.4f} ({images / dt:.1f} img/s)")
        if not meter.count:
            return meter.means()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        means = meter.means()
        means["img_per_sec"] = images / max(time.perf_counter() - t0, 1e-9)
        return means

    def train(self):
        """Full run: epochs x (train pass + valid pass) + checkpoints
        (reference: model_train.py:54-88). SIGTERM or SIGINT checkpoints
        and stops at the end of the current epoch; on a mesh a signal to
        any rank stops every rank there (the flag's max over the ranks),
        so none is left waiting in a collective of the next epoch.
        Returns the state."""
        cfg = self.cfg
        stop = {"now": False}

        def _handler(signum, frame):
            print(f">>> signal {signum}: will checkpoint and stop after this epoch")
            stop["now"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                pass
        try:
            self._log(f">>> devices: {self.mesh.size} (mesh {self.mesh.shape}; "
                      f"{self.device}"
                      + (f", {dist.get_backend()}" if self.mesh.size > 1 else "") + ")")
            self._log(f">>> train iters/epoch {len(self.train_loader)}, "
                      f"valid iters/epoch {len(self.valid_loader)}")
            for epoch in range(self.start_epoch, cfg.epoch):
                profiler = self._start_profile() \
                    if cfg.profile_dir and epoch == self.start_epoch else None
                train_log = self._epoch(epoch, training=True)
                valid_log = self._epoch(epoch, training=False)
                if profiler is not None:
                    profiler.stop()
                    os.makedirs(cfg.profile_dir, exist_ok=True)
                    rank = f"_rank{self.mesh.rank}" if self.mesh.size > 1 else ""
                    profiler.export_chrome_trace(
                        os.path.join(cfg.profile_dir, f"trace_epoch{epoch}{rank}.json"))

                for split, log in (("train", train_log), ("valid", valid_log)):
                    for key in LOG_METRICS:
                        self.history[split][key].append(log.get(key, float("nan")))
                self._print(epoch, train_log, valid_log)

                eigen_log = None
                if cfg.eigen_every and (epoch + 1) % cfg.eigen_every == 0:
                    # telemetry only: a failed sweep (say, a test scene with
                    # no velodyne file) must not skip the checkpoint below
                    try:
                        eigen_log = self.eigen_eval()
                    except Exception as exc:  # noqa: BLE001
                        self._log(f">>> eigen sweep failed (training continues): "
                                  f"{type(exc).__name__}: {exc}")
                    if eigen_log and self.main:
                        eigen.print_table(f"eigen test sweep (epoch {epoch + 1})",
                                          eigen_log)
                sampler = None
                if "warp_span" in train_log:
                    sampler = "cuda" if cfg.use_pallas else "plain"
                if self.main:
                    self._append_jsonl(epoch, train_log, valid_log, eigen_log, sampler)

                stop_now = agree_max(self.mesh, float(stop["now"])) > 0
                if (epoch + 1) % max(cfg.ckpt_every, 1) == 0 \
                        or epoch == cfg.epoch - 1 or stop_now:
                    self.checkpointer.save(epoch, self.state)
                    self.checkpointer.export_modules(epoch, self.state)
                if stop_now:
                    self._log(f">>> stopped after epoch {epoch + 1}; resume with "
                              "--resume true")
                    break
            self.checkpointer.wait()  # commit any in-flight async save
            if self.main:
                self._save_curves()
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            self.close()
        return self.state

    def _start_profile(self):
        """`--profile_dir`: record the first epoch (train and valid passes)
        with `torch.profiler`, written as a Chrome trace."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    # ------------------------------------------------------------------
    def _print(self, epoch: int, train_log, valid_log):
        if not self.main:
            return
        header = " | ".join(f"{k:>8}" for k in LOG_METRICS)

        def row(log):
            return " | ".join(f"{log.get(k, float('nan')):8.4f}" for k in LOG_METRICS)

        print(f">>> epoch {epoch + 1}/{self.cfg.epoch} "
              f"[{train_log.get('img_per_sec', 0):.1f} img/s train]")
        print(f"    {'':>6} {header}")
        print(f"    {'train':>6} {row(train_log)}")
        print(f"    {'valid':>6} {row(valid_log)}")

    def _append_jsonl(self, epoch: int, train_log, valid_log,
                      eigen_log=None, warp_sampler: str | None = None):
        """Machine-readable per-epoch record (metrics.jsonl) beside the
        console table and the .npy curves."""

        def clean(log):  # NaN is not valid strict JSON
            return {k: (None if math.isnan(float(v)) else float(v))
                    for k, v in log.items()}

        # the optimizer's schedule evaluated at this epoch (one step an epoch)
        lr = step_decay_schedule(self.cfg.learning_rate, self.cfg.scheduler_step, 1)(epoch)
        record = {"epoch": epoch, "time": time.time(), "lr": float(lr),
                  "train": clean(train_log), "valid": clean(valid_log)}
        if warp_sampler is not None:
            # the warp of the epoch's train pass: "cuda" (the kernels) or
            # "plain" (grid_sample)
            record["warp_sampler"] = warp_sampler
        if eigen_log:
            record["eigen"] = clean(eigen_log)
        os.makedirs(self.save_dir, exist_ok=True)
        with open(os.path.join(self.save_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    def _save_curves(self):
        loss_dir = os.path.join(self.save_dir, "loss")
        os.makedirs(loss_dir, exist_ok=True)
        for split, curves in self.history.items():
            for key, values in curves.items():
                if values:  # never clobber existing curves with nothing
                    np.save(os.path.join(loss_dir, f"{split}_{key}.npy"),
                            np.asarray(values, dtype=np.float64))

    def _load_curves(self):
        loss_dir = os.path.join(self.save_dir, "loss")
        for split, curves in self.history.items():
            for key in curves:
                path = os.path.join(loss_dir, f"{split}_{key}.npy")
                if os.path.exists(path):
                    curves[key] = list(np.load(path)[: self.start_epoch])
