"""Model families (`benchmark/families/`):

- a Monodepth2 configuration without the stereo frame draws what it
  drew before families: SHA-256 sums of the seeded weights, the ring, the
  noises and the reference's losses at 64x96, batch 2, seed 3 (two
  threads), and the counted FLOPs and warp bytes of a 640x192 call;
- the stereo view is rendered where `stereo_T` warps it, for flipped
  and unflipped items alike;
- a configuration of a new family, and a Monodepth2 configuration with
  the stereo frame, are files added to a copy of the benchmark and
  nothing else: their cells run correct at 64x96 on the CPU, and a fault
  makes them incorrect.
"""

import dataclasses
import hashlib
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import families, reference, scenes, train
from benchmark.manifest import HERE, ROOT, cell

PARENT = {
    "r18_mono_640x192.train": dict(
        state_dict="0d16048a22a214760deea2cf9e6f5220c75bb0b821205d9c4ae38406c8e146fc",
        ring="c2b0b4aed81a7278806f099b13e7ef98eff1333781b01c0902299426d1017f19",
        noises="5d4e4e045151eed96e016869d03336c2e77592e3b9c3263172ac8783da80260e",
        losses="038ca6a26c60caab2c291a443c6d5e81bbb45dea0107384c5bc5d9fb5a01e602",
        flops=1_246_168_350_720, warp_bytes=1_274_019_840),
    "r50_mono_640x192.train": dict(
        state_dict="97e8281a3a2fce031c5e7a01ba4fa5fd736eec5d494864b7daf395f1fe517c01",
        ring="c2b0b4aed81a7278806f099b13e7ef98eff1333781b01c0902299426d1017f19",
        noises="5d4e4e045151eed96e016869d03336c2e77592e3b9c3263172ac8783da80260e",
        losses="d5b491388b2efa0cbf61394adb4a47ec8a71d513921ded00d22fa61819b1c0d3",
        flops=2_669_673_185_280, warp_bytes=1_274_019_840),
}


def _digest(items):
    h = hashlib.sha256()
    for key, t in items:
        t = t.detach().cpu().contiguous()
        h.update(f"{key}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_a_monodepth2_cell_draws_what_it_drew_before_families(name, few_threads):
    c = cell(name)
    small = dataclasses.replace(c, config=dict(c.config, height=64, width=96, batch=2))
    s = train.inputs(small, 3, torch.device("cpu"))
    train.exact_matmuls()
    losses = train.reference_steps(s, s.family.reference.F32, torch.device("cpu")).losses
    got = dict(
        state_dict=_digest(sorted(s.state_dict.items())),
        ring=_digest([(f"{i}/{k}", v) for i, b in enumerate(s.batches)
                      for k, v in sorted(b.items())]),
        noises=_digest([(f"{i}/{k}", v) for i, n in enumerate(s.noises)
                        for k, v in sorted(n.items())]),
        losses=hashlib.sha256(struct.pack(f"<{len(losses)}d", *losses)).hexdigest(),
        flops=s.family.train_step_flops(c.config, 12),
        warp_bytes=s.family.warp_train_bytes(c.config, 12))
    assert got == PARENT[name]


def test_the_stereo_view_warps_onto_the_target_with_stereo_t(few_threads):
    """At the scene's true depth the stereo view warped by `stereo_T`
    matches the target away from the borders; with the sign of its
    translation flipped it does not. Flipped items carry the negated
    baseline, as Monodepth2's loader gives them."""
    n, H, W, shift = 24, 96, 320, 14.0
    baseline = scenes.stereo_baselines(scenes.generator(5, 3, "cpu"), n, "cpu")
    keep = {}
    ring = scenes.planar_scenes(scenes.generator(5, 1, "cpu"), n, H, W, shift, 4, "cpu",
                                (0, "s", -1, 1), baseline, keep)
    T = ring["stereo_T"]
    assert torch.equal(T[:, :3, :3], torch.eye(3).expand(n, 3, 3))
    flipped = torch.sign(T[:, 0, 3]) != torch.sign(baseline)
    color = ring["frames"].permute(0, 1, 4, 2, 3).float() / 255.0
    depth = 1.0 / keep["disp"][:, None]

    def error(T):
        grid = reference.sample_grid(depth, ring["K"], ring["inv_K"], T)
        warped = F.grid_sample(color[:, 1], grid, padding_mode="border", align_corners=True)
        margin = int(shift) + 2
        gap = (warped - color[:, 0])[..., 2:-2, margin:-margin].abs()
        return gap.mean((1, 2, 3))

    wrong = T.clone()
    wrong[:, 0, 3] *= -1
    right, off = error(T), error(wrong)
    for group in (flipped, ~flipped):
        assert group.any()
        assert float(right[group].max()) < 0.02
        assert bool((right[group] < off[group] / 5).all())


TWIN_FAMILY = '''"""Monodepth2 under a name of its own, its reference from its own file."""
from benchmark.families.monodepth2 import (NETWORKS, config, disparity_module, inputs,
                                           port, train_step_flops, warp_train_bytes)
from benchmark.references import twin as reference
'''

RUN = r"""
import dataclasses, json, sys, time
sys.path[:0] = [sys.argv[1]]
import torch
torch.set_num_threads(2)
from benchmark import calibrate, check, families
from benchmark.manifest import cell
from benchmark.run import run_cell

def half_batch(setup):
    step = setup.step
    def half(state, batch, noise):
        n = batch["frames"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()},
                    {k: v[:n] for k, v in noise.items()})
    setup.step = half

def stereo_sign_flipped(setup):
    step = setup.step
    def flipped(state, batch, noise):
        T = batch["stereo_T"].clone()
        T[:, 0, 3] *= -1
        return step(state, dict(batch, stereo_T=T), noise)
    setup.step = flipped

c = cell(sys.argv[2])
c = dataclasses.replace(c, config=dict(c.config, height=64, width=96, batch=4, precision="f32"),
                        traffic=dict(c.traffic, ring=3, trace_calls=2))
out = {"family": families.load(c.family).__name__,
       "reference": families.load(c.family).reference.__file__}
for fault in [None] + [globals()[f] for f in sys.argv[4:]]:
    result, _ = run_cell(c, 2**31 + 9, 0.5, False, torch.device("cpu"), time.time(),
                         fault=fault)
    out[getattr(fault, "__name__", "sound")] = [result["correct"], result["attempted"]]
if sys.argv[3] == "calibrate":
    readings = calibrate.train_seed(c, 7, torch.device("cpu"), True)
    out["calibrate"] = sorted(readings)
    out["control_correct"] = check.verdict(readings["control"], c.limits)[0]
print(json.dumps(out))
"""


def _files_only_tree(tmp_path, config_name, config, workload):
    """A copy of the benchmark with a configuration, its cell and limits
    added, and every file the copy holds from before left as it was."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "monodepth_tpu_torch").symlink_to(ROOT / "monodepth_tpu_torch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = next(c for c in spec["configs"] if c["name"] == "r18_mono_640x192")
    spec["configs"].append(dict(base, name=config_name,
                                file=f"benchmark/configs/{config_name}.json"))
    spec["workloads"].append(dict(name=workload, config=config_name, traffic="train_ring",
                                  chips=1, why="a configuration added as files alone"))
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "r18_mono_640x192.train" in metric.get("workloads", []):
            metric["workloads"].append(workload)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "configs" / f"{config_name}.json").write_text(json.dumps(config))
    shutil.copy(HERE / "limits" / "r18_mono_640x192.train.json",
                root / "benchmark" / "limits" / f"{workload}.json")
    return root


def _unchanged(root, added):
    kept = [p for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts
            and p.relative_to(HERE).parts[0] != "tests"]
    assert all((root / "benchmark" / p.relative_to(HERE)).read_bytes() == p.read_bytes()
               for p in kept)
    now = {p.relative_to(root / "benchmark") for p in (root / "benchmark").rglob("*")
           if p.is_file() and "__pycache__" not in p.parts}
    assert now == {p.relative_to(HERE) for p in kept} | set(added)


def _run(root, workload, *how):
    done = subprocess.run([sys.executable, "-c", RUN, str(root), workload, *how],
                          capture_output=True, text=True, timeout=900, cwd=root)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def _base_config():
    return json.loads((HERE / "configs" / "r18_mono_640x192.json").read_text())


def test_a_new_family_is_files_only(tmp_path):
    """A family module and its reference, a configuration naming it, its
    cell and limits: the cell runs correct, half a batch makes it
    incorrect, `calibrate.py` reads its control and its faults, and the
    reference test holds the family's reference to its port."""
    root = _files_only_tree(tmp_path, "r18_twin_640x192", dict(_base_config(), family="twin"),
                            "r18_twin_640x192.train")
    (root / "benchmark" / "families" / "twin.py").write_text(TWIN_FAMILY)
    (root / "benchmark" / "references").mkdir()
    shutil.copy(HERE / "reference.py", root / "benchmark" / "references" / "twin.py")
    _unchanged(root, [Path("families/twin.py"), Path("references/twin.py"),
                      Path("configs/r18_twin_640x192.json"),
                      Path("limits/r18_twin_640x192.train.json")])

    out = _run(root, "r18_twin_640x192.train", "calibrate", "half_batch")
    assert out["family"] == "benchmark.families.twin"
    assert out["reference"] == str(root / "benchmark" / "references" / "twin.py")
    assert out["sound"][0] is True and out["sound"][1] > 0
    assert out["half_batch"][0] is False
    assert {"program", "program_precision", "control", "fp8_convs", "bf16_stack",
            "half_batch", "grad1_network_medians"} <= set(out["calibrate"])
    assert out["control_correct"] is False

    shutil.copytree(HERE / "tests", root / "benchmark" / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "benchmark/tests/test_bench_reference.py::test_train_steps_match_the_port"
         "[r18_twin_640x192.train]",
         *(f"benchmark/tests/test_bench_manifest.py::{t}" for t in (
             "test_every_entry_has_its_files",
             "test_the_reference_imports_nothing_of_the_program"))],
        capture_output=True, text=True, timeout=900, cwd=root)
    assert done.returncode == 0 and "3 passed" in done.stdout, done.stdout[-3000:]


def test_a_stereo_configuration_is_files_only(tmp_path):
    """Monodepth2 with the stereo frame: a configuration, its cell and
    limits; the cell runs correct, and a stereo_T of the wrong sign makes
    it incorrect."""
    root = _files_only_tree(tmp_path, "r18_ms_640x192",
                            dict(_base_config(), frame_ids=[0, -1, 1, "s"]),
                            "r18_ms_640x192.train")
    _unchanged(root, [Path("configs/r18_ms_640x192.json"),
                      Path("limits/r18_ms_640x192.train.json")])
    out = _run(root, "r18_ms_640x192.train", "run", "stereo_sign_flipped")
    assert out["family"] == "benchmark.families.monodepth2"
    assert out["sound"][0] is True and out["sound"][1] > 0
    assert out["stereo_sign_flipped"][0] is False
