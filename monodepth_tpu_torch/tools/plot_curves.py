"""Plot the per-epoch metric curves a training run saves as .npy files.

Counterpart of the JAX package's `tools/plot_curves.py` (numpy code,
copied: the port imports nothing of the JAX package). The reference
exposes this as `Tools.show_graph` (model_utility.py:305-325, an
interactive matplotlib helper over the `model_save/<save>/loss/*.npy`
curves its logger dumps). The port's Trainer saves the same curves for
both splits (`loss/train_<metric>.npy`, `loss/valid_<metric>.npy`,
`training/loop.py` `_save_curves`); this tool renders them to a PNG grid,
one panel per metric with train and valid overlaid:

    python -m monodepth_tpu_torch.tools.plot_curves <save_dir> [out.png]

<save_dir> is the run directory holding loss/ (e.g. model_save/test).
matplotlib stays optional, as in `utils/visualize.py`: it is imported only
to plot (Agg backend, headless-safe), and without it the tool says so and
exits 1; `load_curves` needs numpy alone.
"""

from __future__ import annotations

import os
import sys

import numpy as np

METRICS = ["loss", "abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"]


def load_curves(save_dir: str):
    """{metric: {split: np.ndarray}} for whichever curves exist."""
    loss_dir = os.path.join(save_dir, "loss")
    out = {}
    for metric in METRICS:
        series = {}
        for split in ("train", "valid"):
            path = os.path.join(loss_dir, f"{split}_{metric}.npy")
            if os.path.exists(path):
                series[split] = np.load(path)
        if series:
            out[metric] = series
    return out


def plot(curves, out_path: str, title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(curves)
    cols = min(4, max(n, 1))
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    for ax, (metric, series) in zip(axes.flat, curves.items()):
        for split, values in series.items():
            epochs = np.arange(1, len(values) + 1)
            ax.plot(epochs, values, marker="o", markersize=3, label=split)
        ax.set_title(metric)
        ax.set_xlabel("epoch")
        ax.grid(True, alpha=0.3)
        ax.legend()
    for ax in axes.flat[n:]:
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    save_dir = argv[0]
    out_path = argv[1] if len(argv) > 1 else os.path.join(save_dir,
                                                          "curves.png")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed; curves remain available as "
              f"{os.path.join(save_dir, 'loss')}/*.npy")
        return 1
    curves = load_curves(save_dir)
    if not curves:
        print(f"no curves under {os.path.join(save_dir, 'loss')}")
        return 1
    plot(curves, out_path, title=os.path.basename(os.path.abspath(save_dir)))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
