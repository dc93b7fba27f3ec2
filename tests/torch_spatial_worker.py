"""The port's spatial warp (`training/step.py` `_spatial_sampler`) in one
process per rank of a {data: 2, spatial: 2} mesh on the CPU (gloo), for
tests/test_torch_parallel.py. Imports no jax.

    python tests/torch_spatial_worker.py INPUTS.npz OUT_DIR

INPUTS.npz holds `img` [B, H, W, 3] and one [B, H, W, 2] grid per field
(`fields`: their names). Each rank warps its piece of each field (batch
over data, rows over spatial) with halo 8, in train form (gradient of
sum(out²) to the grid) and eval form, and writes OUT_DIR/rank<r>.npz:
<field>_out, <field>_dgrid, <field>_eval and <field>_fallbacks."""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.parallel import init_distributed, make_mesh, warm_collectives
from monodepth_tpu_torch.parallel.run_steps import spawn
from monodepth_tpu_torch.training.step import _spatial_sampler, spatial_fallback


def run(paths) -> None:
    inputs, out_dir = paths
    init_distributed("cpu", timeout_s=60)
    mesh = make_mesh(2, 2, "cpu")
    assert warm_collectives(mesh) == 4.0
    data = np.load(inputs)
    img = data["img"]
    B, H, W, _ = img.shape
    cfg = Config(height=H, width=W, batch=B, spatial_halo=8)
    sampler = _spatial_sampler(cfg, mesh)
    b, rows = B // mesh.data, H // mesh.spatial
    items = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    own_rows = slice(mesh.spatial_index * rows, (mesh.spatial_index + 1) * rows)
    own = torch.from_numpy(np.ascontiguousarray(img[items, own_rows]))
    result = {}
    for name in data["fields"]:
        grid = torch.from_numpy(np.ascontiguousarray(data[name][items, own_rows]))
        before = spatial_fallback.calls
        g = grid.clone().requires_grad_(True)
        out = sampler(own, g, True)
        (out ** 2).sum().backward()
        with torch.inference_mode():
            result[f"{name}_eval"] = sampler(own, grid, False).numpy()
        result[f"{name}_out"] = out.detach().numpy()
        result[f"{name}_dgrid"] = g.grad.numpy()
        result[f"{name}_fallbacks"] = spatial_fallback.calls - before
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **result)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    codes = spawn(run, 4, (sys.argv[1], sys.argv[2]), deadline_s=200)
    sys.exit(0 if codes == [0] * 4 else 1)
