"""The f32 split-batch gap: why a mesh's f32 first-step gradients sit
~1e-3 rel-L2 from one device's while its f64 ones agree to 1e-14.

    python tests/split_batch_gap.py          # the port, one process
    python tests/split_batch_gap.py --jax    # and JAX's own gap (CPU)

At 64x96, batch 4, frames (0, -1, 1), scales 0-3, the kernels off, one
seeded init and `make_planar_scenes` batch:

1. (--jax) JAX's gap: the f32 gradient of its train loss on a {data: 2}
   mesh of two virtual CPU devices against its one-device gradient, same
   parameters, batch and noise key (GSPMD computes the same function).
2. The port in one process: the first train step's gradient on the batch,
   and on the batch with its colour-jitter factors moved by one f32 ulp
   (a perturbation at the size of a mesh's rounding), in f32 and f64; the
   pixels whose per-pixel minimum takes another channel ("minimum") or
   whose automask choice flips ("automask") between the two; and the f32
   gap again with those pixels taken out of the automask contest in both
   runs (their tie-break noise raised by 1, so a reprojection wins).

Prints one JSON line of per-module gradient rel-L2 and flip counts. Not a
test: a measurement, run by hand, that ROADMAP.md section 3 cites."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HEIGHT, WIDTH, BATCH = 64, 96, 4


def _batch(dtype):
    from monodepth_tpu_torch.data.synthetic import make_planar_scenes

    scenes = make_planar_scenes(BATCH, HEIGHT, WIDTH, seed=0)
    return {"frames": scenes["frames"], "jitter": scenes["jitter"].astype(dtype),
            "K": scenes["K"].astype(dtype), "inv_K": scenes["inv_K"].astype(dtype)}


def _rel_l2(a: dict, b: dict) -> dict:
    return {m: float(np.linalg.norm(a[m] - b[m]) / np.linalg.norm(b[m])) for m in b}


def jax_gap() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from monodepth_tpu.config import Config
    from monodepth_tpu.parallel import make_mesh, replicate, shard_batch
    from monodepth_tpu.training.state import build_model, create_state, make_optimizer
    from monodepth_tpu.training.step import _loss_from_outputs, apply_and_warp

    cfg = Config(height=HEIGHT, width=WIDTH, batch=BATCH, precision="f32",
                 weight_init=False, use_pallas=False)
    model = build_model(cfg)
    state = create_state(cfg, model, make_optimizer(cfg, steps_per_epoch=10))
    rng = jax.random.PRNGKey(1)

    def grads(params, stats, batch):
        def loss_fn(p):
            out = apply_and_warp(model, {"params": p, "batch_stats": stats}, batch, cfg,
                                 train=True)
            return _loss_from_outputs(out, rng, cfg, train=True)[0]
        return jax.grad(loss_fn)(params)

    step = jax.jit(grads)
    batch = _batch(np.float32)
    one = step(state.params, state.batch_stats, batch)
    mesh = make_mesh(2, 1)
    rep = replicate(mesh, state)
    two = step(rep.params, rep.batch_stats, shard_batch(mesh, batch))

    def flat(tree):
        return {m: np.concatenate([np.asarray(x, np.float64).ravel()
                                   for x in jax.tree.leaves(tree[m])]) for m in tree}

    return _rel_l2(flat(two), flat(one))


def port_gap() -> dict:
    import torch

    from monodepth_tpu_torch.config import Config
    from monodepth_tpu_torch.losses.reprojection import monodepth_loss
    from monodepth_tpu_torch.training.state import build_model, module_grads
    from monodepth_tpu_torch.training.step import apply_and_warp

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    cfg = Config(height=HEIGHT, width=WIDTH, batch=BATCH, precision="f32",
                 weight_init=False, use_pallas=False)

    def run(model, batch, noise):
        model.zero_grad(set_to_none=True)
        model.train()
        out = apply_and_warp(model, batch, cfg, train=True)
        loss, aux = monodepth_loss(out["disps"], out["warped"], out["sources"],
                                   out["target_pyr"], noise, scales=cfg.scales,
                                   disp_smoothness=cfg.disp_smoothness, choices=True)
        loss.backward()
        return module_grads(model), {s: aux[f"choice/{s}"] for s in cfg.scales}

    result = {}
    for name, dtype in (("f32", np.float32), ("f64", np.float64)):
        model = build_model(cfg, device="cpu")
        if dtype == np.float64:
            model.double()
        tdtype = torch.float64 if dtype == np.float64 else torch.float32
        base = {k: torch.from_numpy(v) for k, v in _batch(dtype).items()}
        moved = dict(base, jitter=torch.from_numpy(np.nextafter(
            base["jitter"].numpy(), np.inf, dtype=dtype)))
        gen = torch.Generator().manual_seed(0)
        shape = (BATCH, HEIGHT, WIDTH, len(cfg.source_frame_ids))
        noise = {s: 1e-5 * torch.randn(shape, generator=gen, dtype=tdtype)
                 for s in cfg.scales}
        state = {k: v.clone() for k, v in model.state_dict().items()}
        g_a, c_a = run(model, base, noise)
        model.load_state_dict(state)
        g_b, c_b = run(model, moved, noise)
        n = len(cfg.source_frame_ids)
        flipped = {s: c_a[s] != c_b[s] for s in cfg.scales}
        entry = {"grad_rel_l2": _rel_l2({m: g.numpy() for m, g in g_b.items()},
                                        {m: g.numpy() for m, g in g_a.items()}),
                 "minimum": {s: int(f.sum()) for s, f in flipped.items()},
                 "automask": {s: int(((c_a[s] < n) != (c_b[s] < n)).sum())
                              for s in cfg.scales},
                 "pixels": int(c_a[0].numel())}
        if name == "f32":
            masked = {s: v + flipped[s][..., None].to(v.dtype) for s, v in noise.items()}
            model.load_state_dict(state)
            m_a, _ = run(model, base, masked)
            model.load_state_dict(state)
            m_b, mc_b = run(model, moved, masked)
            entry["masked_grad_rel_l2"] = _rel_l2({m: g.numpy() for m, g in m_b.items()},
                                                  {m: g.numpy() for m, g in m_a.items()})
        result[name] = entry
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jax", action="store_true")
    args = p.parse_args(argv)
    out = {"port_one_ulp": port_gap()}
    if args.jax:
        out["jax_data2_vs_one_device_f32"] = jax_gap()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
