"""Convert PyTorch checkpoints to the per-module npz sets that both eval
CLIs read (`python -m monodepth_tpu_torch.model_test` and the JAX
package's `model_test.py`).

1. ImageNet init: torchvision `resnet<N>.pth` -> `<out>/resnet<N>.npz`
   (reference: depth_encoder.py:57-60).
2. Official / reference Monodepth2 checkpoints -> `encoder<E>.npz`,
   `decoder<E>.npz`, `pose_encoder<E>.npz`, `pose_decoder<E>.npz`
   (reference checkpoint layout: model_tool/logger.py:60-66; official
   weights: model_test.py:29-43).

Usage:
    python -m monodepth_tpu_torch.tools.convert_torch_weights imagenet resnet18.pth pretrained/
    python -m monodepth_tpu_torch.tools.convert_torch_weights monodepth2 <dir-with-pth> <out-dir> \
        --epoch 0 [--num_layers 18]

Reads local .pth files only (torch on the CPU is enough).
"""

from __future__ import annotations

import argparse
import os

from monodepth_tpu_torch.utils.serialization import save_npz
from monodepth_tpu_torch.utils.torch_import import (
    depth_decoder_params,
    load_torch_file,
    pose_cnn_params,
    pose_decoder_params,
    resnet_encoder_variables,
)


def convert_imagenet(src: str, out_dir: str, num_layers: int) -> str:
    sd = load_torch_file(src)
    tree = resnet_encoder_variables(sd, num_layers, 1)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"resnet{num_layers}.npz")
    save_npz(out, tree)
    return out


def convert_monodepth2(src_dir: str, out_dir: str, epoch: int,
                       num_layers: int) -> list[str]:
    """Convert a directory of Monodepth2-style .pth files. Recognized
    names: encoder.pth/depth.pth/pose.pth/pose_encoder.pth (official) and
    encoder<N>.pt/decoder<N>.pt/pose_decoder<N>.pt/pose_encoder<N>.pt
    (reference trainer exports)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def emit(name, tree):
        path = os.path.join(out_dir, f"{name}{epoch}.npz")
        save_npz(path, tree)
        written.append(path)

    candidates = {f.lower(): f for f in os.listdir(src_dir)}

    def find(*names):
        for n in names:
            if n in candidates:
                return os.path.join(src_dir, candidates[n])
        return None

    enc = find("encoder.pth", f"encoder{epoch}.pt")
    if enc:
        emit("encoder", resnet_encoder_variables(
            load_torch_file(enc), num_layers, 1))
    dec = find("depth.pth", f"decoder{epoch}.pt")
    if dec:
        emit("decoder", {"params": depth_decoder_params(load_torch_file(dec))})
    pe = find("pose_encoder.pth", f"pose_encoder{epoch}.pt")
    if pe:
        emit("pose_encoder", resnet_encoder_variables(
            load_torch_file(pe), num_layers, 2))
    pd = find("pose.pth", f"pose_decoder{epoch}.pt")
    if pd:
        sd = load_torch_file(pd)
        if any(k.startswith("pose_conv") for k in sd):
            emit("pose_decoder", {"params": pose_cnn_params(sd)})
        else:
            emit("pose_decoder", {"params": pose_decoder_params(sd)})
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    a = sub.add_parser("imagenet")
    a.add_argument("src")
    a.add_argument("out_dir")
    a.add_argument("--num_layers", type=int, default=18)
    b = sub.add_parser("monodepth2")
    b.add_argument("src_dir")
    b.add_argument("out_dir")
    b.add_argument("--epoch", type=int, default=0)
    b.add_argument("--num_layers", type=int, default=18)
    args = p.parse_args(argv)

    if args.mode == "imagenet":
        print(convert_imagenet(args.src, args.out_dir, args.num_layers))
    else:
        for path in convert_monodepth2(args.src_dir, args.out_dir,
                                       args.epoch, args.num_layers):
            print(path)


if __name__ == "__main__":
    main()
