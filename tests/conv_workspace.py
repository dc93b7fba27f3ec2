"""Peak card memory of single convolutions, forward and backward: the
whole level against a row piece as `parallel.rows.conv2d` runs it (half
the rows plus the halo, H padding 0), f32 (TF32 off, as `--precision f32`
sets it) and bf16.

    python tests/conv_workspace.py      # needs a card

For each of a few convolutions of the 640x192 b12 step (the depth and
pose stems, 3x3s of layer1 and layer2, a decoder 3x3) prints the peak of
`torch.cuda.max_memory_allocated` above its inputs in MiB. A peak far
above the output and gradient sizes is the workspace of the algorithm
cuDNN chose for that shape. Not a test: a measurement, run by hand, that
PERF.md section 7 cites."""

import torch
import torch.nn.functional as F

CASES = [("stem", 12, 3, 64, 7, 2, 192, 640), ("pose stem", 24, 6, 64, 7, 2, 192, 640),
         ("layer1 3x3", 12, 64, 64, 3, 1, 48, 160),
         ("layer2 3x3 s2", 12, 64, 128, 3, 2, 48, 160),
         ("layer2 3x3", 12, 128, 128, 3, 1, 24, 80), ("dec 3x3", 12, 32, 16, 3, 1, 192, 640)]


def peak_mib(B, cin, cout, k, stride, rows, W, pad, dtype) -> float:
    x = torch.randn(B, cin, rows, W, device="cuda", dtype=dtype, requires_grad=True)
    w = torch.randn(cout, cin, k, k, device="cuda", dtype=dtype, requires_grad=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = F.conv2d(x, w, None, stride, pad)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        torch.backends.cudnn.allow_tf32 = dtype == torch.bfloat16
        for name, B, cin, cout, k, stride, H, W in CASES:
            p = (k - 1) // 2
            whole = peak_mib(B, cin, cout, k, stride, H, W, (p, p), dtype)
            torch.cuda.empty_cache()
            piece = peak_mib(B, cin, cout, k, stride, H // 2 + 2 * p, W, (0, p), dtype)
            torch.cuda.empty_cache()
            print(f"{str(dtype):15s} {name:14s} peak above inputs MiB: whole {whole:.1f}  "
                  f"row piece {piece:.1f}", flush=True)


if __name__ == "__main__":
    main()
