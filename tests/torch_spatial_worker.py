"""The port's spatial warp (`training/step.py` `_spatial_sampler`, both
forms: the eager branch and the captured steps' `gather`) in one process
per rank of a mesh on the CPU (gloo), for tests/test_torch_parallel.py
and tests/test_torch_spatial_graph.py. Imports no jax.

    python tests/torch_spatial_worker.py INPUTS.npz OUT_DIR [DATA SPATIAL HALO]

(default {data: 2, spatial: 2}, halo 8). INPUTS.npz holds `img`
[B, H, W, 3] and one [B, H, W, 2] grid per field (`fields`: their names).
Each rank warps its piece of each field (batch over data, rows over
spatial), in train form (gradient of sum(out²) to the grid) and eval
form, and writes OUT_DIR/rank<r>.npz: <field>_out, <field>_dgrid,
<field>_eval, and the warps each form ran, <field>_fallbacks (exact
warps) and <field>_slab_warps; and the same of the gather form under
<field>_gather_out, ..."""

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.parallel import init_distributed, make_mesh, warm_collectives
from monodepth_tpu_torch.parallel.run_steps import spawn
from monodepth_tpu_torch.training.step import _spatial_sampler, local_warp, spatial_fallback


def run(args) -> None:
    inputs, out_dir, data_n, spatial_n, halo = args
    init_distributed("cpu", timeout_s=60)
    mesh = make_mesh(data_n, spatial_n, "cpu")
    assert warm_collectives(mesh) == data_n * spatial_n
    data = np.load(inputs)
    img = data["img"]
    B, H, W, _ = img.shape
    cfg = Config(height=H, width=W, batch=B, spatial_halo=halo)
    samplers = {"": _spatial_sampler(cfg, mesh),
                "_gather": _spatial_sampler(cfg, mesh, gather=True)}
    b, rows = B // mesh.data, H // mesh.spatial
    items = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    own_rows = slice(mesh.spatial_index * rows, (mesh.spatial_index + 1) * rows)
    own = torch.from_numpy(np.ascontiguousarray(img[items, own_rows]))
    result = {}
    for name, form in ((n, f) for n in data["fields"] for f in samplers):
        sampler, key = samplers[form], f"{name}{form}"
        grid = torch.from_numpy(np.ascontiguousarray(data[name][items, own_rows]))
        before = spatial_fallback.calls, local_warp.calls
        g = grid.clone().requires_grad_(True)
        out = sampler(own, g, True)
        (out ** 2).sum().backward()
        with torch.inference_mode():
            result[f"{key}_eval"] = sampler(own, grid, False).numpy()
        result[f"{key}_out"] = out.detach().numpy()
        result[f"{key}_dgrid"] = g.grad.numpy()
        result[f"{key}_fallbacks"] = spatial_fallback.calls - before[0]
        result[f"{key}_slab_warps"] = local_warp.calls - before[1]
    np.savez(Path(out_dir) / f"rank{mesh.rank}.npz", **result)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    data_n, spatial_n, halo = (int(a) for a in sys.argv[3:6]) if len(sys.argv) > 3 \
        else (2, 2, 8)
    world = data_n * spatial_n
    codes = spawn(run, world, (sys.argv[1], sys.argv[2], data_n, spatial_n, halo),
                  deadline_s=200)
    sys.exit(0 if codes == [0] * world else 1)
