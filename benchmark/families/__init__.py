"""Model families: what the benchmark knows of one kind of model.

A configuration file (`configs/<name>.json`) names its family with the
note `"family": "<name>"`; a file without it is `monodepth2`. The family
is the module `families/<name>.py`. The train driver (`train.py`), the
seeded weights (`weights.py`) and the calibration (`calibrate.py`) reach
the model, the program's and the reference's, through it alone, so a
configuration of another family is new files: its family module, its
reference, its configuration file (and the cell's limits and
`BENCHMARK.json` entries).

A family module defines:

`reference`
    The plain reference, a module of its own file (`benchmark/reference.py`
    for `monodepth2`; a new family's in `benchmark/references/<family>.py`),
    written from the published model in plain PyTorch. It imports nothing
    of the program nor JAX, and takes nothing the program made: the driver
    hands it the seeded weights and the inputs, and turns TF32 off before
    it runs. It defines
    - `F32`, the reference's arithmetic (float32); `F64`, float64, in
      which the CPU tests hold it to the program; `PROGRAM_PRECISION`, the
      configuration's stated precision, which shows how far that rounding
      alone moves each number; and `CONTROLS`, {name: arithmetic} of the
      control, the precision below the configuration's, first under the
      name "control", then its parts: `calibrate.py` reads each;
    - `ADAM`, (beta1, beta2, eps) of the optimizer both sides run: the
      driver reads the program's first gradients from its first moments;
    - `build(conf, numerics=F32, device="cpu") -> nn.Module`: the model of
      a configuration's fields, uninitialised, its state_dict named as the
      program's model's (on the meta device: the names and shapes alone);
    - `fan_init_std(name, shape) -> float`: the seeded init's standard
      deviation of the convolution weight `name` (every other leaf starts
      as `weights.py` says);
    - `loss_and_grads(model, conf, batch, noise) -> (loss, {leaf: grad})`:
      one forward and backward in train mode;
    - `train_steps(model, conf, batches, noises, lr) -> Trajectory`: steps
      with Adam from zero moments at rate `lr` (or one rate a step), their
      losses, the first two gradients, the first step's finest disparity
      and the parameters after it, and the parameters and batch-norm
      running statistics after the last (the fields of
      `reference.Trajectory`).

`config(conf)`
    The program's configuration of a configuration file's fields (the
    notes left out); raises on a field the program does not take.

`inputs(conf, traffic, seed, n, device) -> (batches, noises)`
    The ring: `traffic["ring"]` batches of `n` items, as the program's
    train step takes them (each entry's first axis the items), and each
    step's noise, made on `device` from the seed in a few large calls by
    `scenes.generator(seed, purpose, device)`. Purposes 0 (the weights),
    1 (`monodepth2`'s scenes), 2 (its tie noise) and 3 (its stereo
    baselines) are taken: a new draw takes a purpose no other uses, so
    that what is drawn already stays as it is.

`port(conf, state_dict, device, mesh, steps_per_epoch) -> (state, step)`
    The program's train state and train step, the step the program's
    trainer calls, loaded with `state_dict`; on a mesh, this rank's, with
    rank 0's state on every rank. `state.model` is the program's model,
    its parameters named as the reference's; `state.optimizer` its
    `torch.optim.Adam`; `step(state, batch, noise)` trains one step in
    place and returns {"loss": tensor, ...}.

`disparity_module(model) -> nn.Module`
    The module of the program's model whose forward returns {scale:
    disparity}; the check reads the finest scale of the first call.

`NETWORKS`
    The state_dict prefixes of the model's networks, by which
    `calibrate.network_medians` groups the first gradient's gaps.

`train_step_flops(conf, batch)`, `warp_train_bytes(conf, batch)`
    A train step's counted convolution operations and the least bytes of
    its warp kernels (K1, K1-bwd), or None where the family has no such
    work. The readers `metrics/mfu.train.py` and
    `metrics/warp_roofline_pct.train.py` take a count as given: a cell
    whose family returns None stays out of that metric's `workloads`.

A configuration names its batch (`batch`, a card's items), its rate
(`learning_rate`) and its `scales`, which the driver reads.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
DEFAULT = "monodepth2"


def load(name: str) -> ModuleType:
    """The family module `families/<name>.py`."""
    path = HERE / f"{name}.py"
    if not name.isidentifier() or name.startswith("_") or not path.is_file():
        raise ValueError(f"model family {name!r}: no family file {path}")
    return importlib.import_module(f"{__name__}.{name}")
