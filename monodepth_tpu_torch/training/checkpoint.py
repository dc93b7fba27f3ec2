"""Checkpoint and resume of the full train state, and the per-module npz
export.

Counterpart of `monodepth_tpu.training.checkpoint` (reference:
model_tool/logger.py:51-68, which saved per-module state_dicts and no
optimizer). A checkpoint `state_{epoch:04d}.pt` holds the model's
state_dict (parameters and batch-norm buffers), the optimizer's
state_dict (Adam's moments and step counts), `TrainState.step`,
`TrainState.seed` and the epoch, so a resumed run continues bit for bit.
The per-module export `<module><epoch + 1>.npz` is written in the JAX
package's npz layout, which both packages' `model_test` read.

In a process group (the Trainer on a mesh) the state is replicated, so
rank 0 alone writes, exports and prunes (JAX `checkpoint.py:91, 135`), and
every rank waits at a barrier until the files are committed before it
goes on, so no rank reads a file that is still being written.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from monodepth_tpu_torch.training.state import TrainState, load_optimizer_state
from monodepth_tpu_torch.utils.jax_export import jax_variables
from monodepth_tpu_torch.utils.serialization import save_npz


def _host_copy(value: Any) -> Any:
    """`value` with every tensor copied to host memory (a new tensor even
    where it already lies on the CPU), dicts and lists walked."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_host_copy(v) for v in value)
    return value


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _barrier() -> None:
    if _grouped():
        dist.barrier()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 0, async_save: bool = False):
        """`keep` > 0 keeps only the newest `keep` states (and their module
        exports) after each save; the newest is always kept. 0 keeps all.

        `async_save`: `save` copies the state to host memory before it
        returns, and only the file write runs on a background thread. The
        train step updates the parameters and Adam's moments in place, so
        a thread that read the card's tensors after training resumed would
        save a torn state. At most one write is in flight: a new `save`
        (or `wait()`) joins the previous one first. Every file is written
        to a temporary name and renamed, so an interrupted run loses at
        most the newest checkpoint.

        In a process group only rank 0 writes: its snapshot, its write
        thread. A synchronous `save` and `export_modules` end at a barrier
        after rank 0's files are committed; with `async_save` the barrier
        is in `wait()`, after rank 0 has joined its write."""
        self.directory = os.path.abspath(directory)
        self._writer = not _grouped() or dist.get_rank() == 0
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._async = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"state_{epoch:04d}.pt")

    def _write(self, path: str, snapshot: dict) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(snapshot, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _write_in_thread(self, path: str, snapshot: dict) -> None:
        try:
            self._write(path, snapshot)
        except Exception as exc:  # noqa: BLE001 - re-raised by _join
            self._error = exc

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("the background checkpoint write failed") from error

    def save(self, epoch: int, state: TrainState) -> str:
        """Write the full state of `epoch` (rank 0); returns its path."""
        path = self._path(epoch)
        if not self._writer:
            if not self._async:
                _barrier()
            return path
        self._join()
        snapshot = {"model": _host_copy(state.model.state_dict()),
                    "optimizer": _host_copy(state.optimizer.state_dict()),
                    "step": int(state.step), "seed": int(state.seed),
                    "epoch": int(epoch)}
        if self._async:
            self._thread = threading.Thread(target=self._write_in_thread,
                                            args=(path, snapshot),
                                            name="checkpoint", daemon=False)
            self._thread.start()
        else:
            self._write(path, snapshot)
        # the in-flight write is not yet under its final name, so this
        # prunes the generations before it; `wait()` prunes after it
        self._prune()
        if not self._async:
            _barrier()
        return path

    def wait(self) -> None:
        """Join any in-flight write (raising its error), then prune; in a
        process group every rank then waits at a barrier."""
        if self._writer:
            self._join()
            self._prune()
        _barrier()

    def _epochs(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := re.fullmatch(r"state_(\d+)\.pt", name)))

    def _prune(self) -> None:
        if self.keep <= 0 or not self._writer:
            return
        for old in self._epochs()[:-self.keep]:
            os.remove(self._path(old))
            # the matching module exports, named <module><epoch + 1>.npz
            for name in os.listdir(self.directory):
                if re.fullmatch(rf"[a-z_]+{old + 1}\.npz", name):
                    os.remove(os.path.join(self.directory, name))

    def latest_epoch(self) -> Optional[int]:
        """The newest checkpoint's epoch, None without one. In a process
        group every rank gets rank 0's answer (one broadcast), so the ranks
        take the same branch on it even where their views of the directory
        differ."""
        epochs = self._epochs()
        latest = epochs[-1] if epochs else None
        if _grouped():
            agreed = [latest]
            dist.broadcast_object_list(agreed, src=0)
            latest = agreed[0]
        return latest

    def restore(self, state: TrainState, epoch: int | None = None
                ) -> tuple[TrainState, int]:
        """Load checkpoint `epoch` (default: the latest, as rank 0 names
        it) into `state` in place: the model's parameters and buffers, the
        optimizer, step and seed. Returns (state, epoch restored). The file
        is read to the CPU (`weights_only`): `load_state_dict` copies the
        model's tensors onto its device, and `load_optimizer_state` moves
        Adam's moments onto the parameters' device, its step counts where
        the live Adam keeps them, and keeps the live Adam's settings. The
        parameters, buffers and moments are copied or replaced, so a step
        captured in a CUDA graph before the restore captures again on its
        next call (`training.graphs`). In a process group the ranks
        agree on the read (one all-gather) before any of them goes on: if
        one rank cannot read the file, every rank raises, naming it."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        data, failure = None, None
        try:
            data = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        except Exception as exc:  # noqa: BLE001 - the peers must hear of it
            failure = exc
        if _grouped():
            failures = [None] * dist.get_world_size()
            dist.all_gather_object(failures, None if failure is None else repr(failure))
            failed = {r: f for r, f in enumerate(failures) if f is not None}
            if failed:
                raise RuntimeError(f"restore of epoch {epoch} failed on rank(s) "
                                   f"{failed}") from failure
        elif failure is not None:
            raise failure
        state.model.load_state_dict(data["model"])
        load_optimizer_state(state.optimizer, data["optimizer"])
        state.step, state.seed = data["step"], data["seed"]
        return state, data["epoch"]

    def export_modules(self, epoch: int, state: TrainState) -> None:
        """`<module><epoch + 1>.npz` for each top-level module, in the JAX
        package's layout (reference: `<key><epoch + 1>.pt`,
        logger.py:60-66): {"params"} and, for the encoders,
        {"batch_stats"}. Rank 0 writes; every rank then waits at a
        barrier."""
        if not self._writer:
            _barrier()
            return
        model = state.model
        variables = jax_variables(model.state_dict(), model.encoder.num_layers,
                                  model.scales)
        stats = variables["batch_stats"]
        for name, tree in variables["params"].items():
            out = {"params": tree}
            if name in stats:
                out["batch_stats"] = stats[name]
            save_npz(os.path.join(self.directory, f"{name}{epoch + 1}.npz"), out)
        _barrier()
