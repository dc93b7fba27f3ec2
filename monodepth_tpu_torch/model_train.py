"""Train CLI on the card (reference: model_train.py:100-101,
`trainer(options()).train()`):

    python -m monodepth_tpu_torch.model_train --pose_type separate \
        --datatype kitti_eigen_zhou --batch 12

The flags are those of the JAX package's `model_train.py`
(`monodepth_tpu_torch/config.py`), plus `--device` (default: the card;
`cpu` runs the plain PyTorch path). Every pose wiring trains:
`--pose_type separate|shared|posecnn`, `--pose_frames 2|all`, and
`--dataset kitti_stereo` for stereo (frames "0 s") or mono+stereo (the
default frames plus "s", which `Config.validate` adds); the loader then
feeds each batch's `stereo_T`. Without a card and without
`--device cpu` it raises. The run writes under `<save_root>/<save>/`:
`state_<epoch>.pt`, the module exports `<module><epoch + 1>.npz` (which
`python -m monodepth_tpu_torch.model_test --weights <dir>:<epoch>`
reads), `metrics.jsonl` and `loss/*.npy`.
"""

from __future__ import annotations

import argparse

from monodepth_tpu_torch.config import options
from monodepth_tpu_torch.training.loop import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default: the card) or cpu")
    args, rest = p.parse_known_args(argv)
    return Trainer(options(rest), device=args.device).train()


if __name__ == "__main__":
    main()
