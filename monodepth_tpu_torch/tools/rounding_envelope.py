"""How far rounding alone moves the one-device train steps.

    python -m monodepth_tpu_torch.tools.rounding_envelope [--device cpu] \\
        [--steps 2] [--f64] [--out FILE] \\
        [config flags, e.g. --pose_type shared --pose_frames all]

Runs `--steps` eager train steps on one device, from the seeded init, on
`run_steps`' batches (`host_batches`), and then the same steps again
under each change that moves rounding only: the run repeated as it was
(0 where the device is deterministic), the colour-jitter factors moved
one ulp up, one down and two up, one up on a single item (the first, the
middle and the last), K and inv_K moved one ulp up, and on a card
cuDNN's autotuned convolution algorithms (`cudnn.benchmark`) in place of
its heuristic choice. Prints one JSON line: per change, each step's loss
rel to the first run's, the first step's gradient rel-L2 by module, and
the per-pixel choices that flip in the first step's forward
(`run_steps.choice_flips`); and the envelope, the largest loss rel of
each step over the changes. A mesh's difference from one device
(`run_steps --reference`) is rounding of the same kind, read beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from monodepth_tpu_torch.config import options
from monodepth_tpu_torch.parallel.run_steps import (
    STEPS_PER_EPOCH,
    choice_flips,
    first_choices,
    host_batches,
    host_grads,
)
from monodepth_tpu_torch.training.state import build_model, create_state, resolve_device
from monodepth_tpu_torch.training.step import make_train_step


def _up(a: np.ndarray, ulps: int = 1) -> np.ndarray:
    for _ in range(abs(ulps)):
        a = np.nextafter(a, np.array(np.inf if ulps > 0 else -np.inf, a.dtype))
    return a


def _one_item(i: int):
    def move(a: np.ndarray) -> np.ndarray:
        a = a.copy()
        a[i] = _up(a[i])
        return a
    return move


def changes(batches: List[dict], cuda: bool) -> Iterator[Tuple[str, List[dict], bool]]:
    """(name, the batches, whether cuDNN autotunes) of each change."""
    def moved(fn, keys=("jitter",)):
        return [{**b, **{k: fn(b[k]) for k in keys}} for b in batches]

    yield "repeat", batches, False
    for ulps in (1, -1, 2):
        yield f"jitter {ulps:+d} ulp", moved(lambda a, u=ulps: _up(a, u)), False
    items = len(batches[0]["jitter"])
    for i in sorted({0, items // 2, items - 1}):
        yield f"jitter +1 ulp, item {i}", moved(_one_item(i)), False
    yield "K, inv_K +1 ulp", moved(_up, ("K", "inv_K")), False
    if cuda:
        yield "cudnn.benchmark", batches, True


def _steps(cfg, model, initial, batches, device, benchmark: bool):
    """The steps from `initial` -> (losses, first-step gradients by
    module, first-step choices)."""
    model.load_state_dict(initial)
    state = create_state(cfg, model, steps_per_epoch=STEPS_PER_EPOCH)
    outer = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = benchmark
    try:
        choices = first_choices(cfg, state, batches[0], None, device)
        step = make_train_step(model, cfg, device=device, graph=False)
        losses, grads = [], None
        for i, batch in enumerate(batches):
            losses.append(float(step(state, batch)["loss"]))
            if i == 0:
                grads = host_grads(model)
    finally:
        torch.backends.cudnn.benchmark = outer
    return losses, grads, choices


def envelope(argv: Sequence[str] | None = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args, config = p.parse_known_args(argv)
    cfg = options(config)
    device = resolve_device(args.device)
    batches = host_batches(cfg, args.steps, np.float64 if args.f64 else np.float32)
    model = build_model(cfg, device=device)
    if args.f64:
        model.double()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    losses, grads, choices = _steps(cfg, model, initial, batches, device, False)
    result = {"config": config, "precision": "f64" if args.f64 else cfg.precision,
              "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
              "losses": losses, "changes": {}}
    for name, moved, benchmark in changes(batches, device.type == "cuda"):
        m_losses, m_grads, m_choices = _steps(cfg, model, initial, moved, device, benchmark)
        result["changes"][name] = {
            "loss_rel": [abs(a - b) / abs(b) for a, b in zip(m_losses, losses)],
            "grad_rel_l2": {m: float((m_grads[m] - g).norm() / g.norm())
                            for m, g in grads.items()},
            "choice_flips": choice_flips(cfg, m_choices, choices)}
    result["envelope"] = [max(c["loss_rel"][i] for c in result["changes"].values())
                          for i in range(args.steps)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


def main(argv: Sequence[str] | None = None) -> int:
    print(json.dumps(envelope(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
