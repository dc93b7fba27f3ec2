"""The port's Eigen protocol and eval CLI against the JAX package's, on one
synthetic KITTI tree and one set of weights (a seeded port model carried
into the JAX tree with `torch_parity.flax_variables` and written as the
JAX package's per-module npz exports). ResNet-18, 64x96, scales (0, 1),
f32; one JAX infer compile (batch 3). BASELINE config 2 at a tiny shape.

- ground truth bit for bit, through a cache round trip;
- `eigen_errors`/`eigen_metrics` at rtol 1e-12 on random disparities;
- `predict_disparities` at rtol 1e-4 of JAX's (eval_batch 3 over 4
  lines: a ragged last batch), and unchanged from eval_batch 3 to 4 at
  rtol 1e-6;
- `state_from_modules` reads the JAX npz set into the same state_dict;
- `detect_scales`, `parse_weights_spec`, the torch -> npz -> torch round
  trip and `convert_torch_weights`;
- `python -m monodepth_tpu_torch.model_test --device cpu` prints the
  table, and its metrics equal JAX's `model_test.py` at rtol 1e-4."""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model_test as jmodel_test
from monodepth_tpu.config import Config as JConfig
from monodepth_tpu.evaluation import eigen as jeigen
from monodepth_tpu.training.state import TrainState as JTrainState
from monodepth_tpu.utils import serialization as jserialization
from monodepth_tpu.utils import torch_import as jtorch_import
from monodepth_tpu_torch import model_test
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.data.synthetic import DRIVE, make_kitti_tree
from monodepth_tpu_torch.evaluation import eigen
from monodepth_tpu_torch.tools import convert_torch_weights
from monodepth_tpu_torch.training.state import MODULES, build_model
from monodepth_tpu_torch.utils import serialization, torch_import
from monodepth_tpu_torch.utils.jax_import import module_state_dict, state_dict_from_jax
from torch_parity import flax_variables, one_thread, randomize_bn_stats

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(height=64, width=96, scales=(0, 1), num_layers=18, precision="f32",
          weight_init=False)
EPOCH = 3
LINES = [f"{DRIVE} {i} {side}" for i, side in ((1, "l"), (2, "r"), (3, "l"), (4, "r"))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(cfg, the port model, its JAX variables, weights dir, splits dir)."""
    base = tmp_path_factory.mktemp("eigen")
    root = make_kitti_tree(str(base / "kitti"), num_frames=6, seed=4, image_hw=(96, 320))
    splits = base / "splits"
    os.makedirs(splits / "kitti_eigen_zhou")
    kitti.savelines(LINES, str(splits / "kitti_eigen_zhou" / "test_files.txt"))
    cfg = Config(datapath=root, splits=str(splits), **KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=6)
    variables = flax_variables(model.state_dict(), cfg)
    weights = base / "weights"
    os.makedirs(weights)
    for name in MODULES:
        tree = {"params": variables["params"][name]}
        if name in variables["batch_stats"]:
            tree["batch_stats"] = variables["batch_stats"][name]
        jserialization.save_npz(str(weights / f"{name}{EPOCH}.npz"), tree)
    return cfg, model, variables, str(weights), str(splits)


def test_ground_truth_bit_for_bit_with_cache(setup, tmp_path):
    cfg, *_ = setup
    theirs = jeigen.load_ground_truth(cfg.datapath, LINES)
    cache = str(tmp_path / "gt")
    first = eigen.load_ground_truth(cfg.datapath, LINES, cache_dir=cache)
    names = sorted(os.listdir(cache))
    again = eigen.load_ground_truth(cfg.datapath, LINES, cache_dir=cache)
    jeigen.load_ground_truth(cfg.datapath, LINES, cache_dir=str(tmp_path / "jgt"))
    assert len(names) == 4 and names == sorted(os.listdir(tmp_path / "jgt"))
    for a, b, c in zip(first, again, theirs):
        assert a.shape == (375, 1242) and a.dtype == np.float32 and (a > 0).any()
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("datatype", ["kitti_eigen_zhou", "kitti_benchmark"])
def test_eigen_errors_and_metrics_match(setup, datatype):
    cfg, *_ = setup
    gts = jeigen.load_ground_truth(cfg.datapath, LINES)
    disps = np.random.default_rng(2).uniform(0.02, 2.0, (4, 64, 96)).astype(np.float32)
    np.testing.assert_allclose(eigen.eigen_errors(disps, gts, datatype),
                               jeigen.eigen_errors(disps, gts, datatype), rtol=1e-12)
    ours = eigen.eigen_metrics(disps, gts, datatype)
    theirs = jeigen.eigen_metrics(disps, gts, datatype)
    assert list(ours) == list(theirs)
    np.testing.assert_allclose(list(ours.values()), list(theirs.values()), rtol=1e-12)
    with pytest.raises(ValueError, match="empty sweep"):
        eigen.eigen_metrics(disps[:0], [], datatype)


def test_resize_bilinear_matches(setup):
    image = np.random.default_rng(3).uniform(size=(64, 96)).astype(np.float32)
    np.testing.assert_array_equal(eigen.resize_bilinear_np(image, 375, 1242),
                                  jeigen.resize_bilinear_np(image, 375, 1242))


@pytest.fixture(scope="module")
def predictions(setup):
    """(port at eval_batch 3, port at 4, JAX at 3) disparities."""
    cfg, model, variables, *_ = setup
    jstate = JTrainState(step=jnp.int32(0), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=None,
                         rng=jax.random.PRNGKey(0))
    jcfg = JConfig(datapath=cfg.datapath, **KW)
    theirs = jeigen.predict_disparities(jcfg, jstate, LINES, eval_batch=3, num_workers=2)
    ours = {b: eigen.predict_disparities(cfg, model, LINES, eval_batch=b,
                                         num_workers=2, device="cpu") for b in (3, 4)}
    return ours[3], ours[4], theirs


def test_predict_disparities_matches_jax(predictions):
    ours, _, theirs = predictions
    assert ours.shape == theirs.shape == (4, 64, 96) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


def test_predict_disparities_independent_of_batch(predictions):
    three, four, _ = predictions
    np.testing.assert_allclose(three, four, rtol=1e-6)


def test_eval_batches_ragged_in_order(setup):
    cfg, *_ = setup
    batches = list(eigen.eval_batches(cfg, LINES, eval_batch=3, num_workers=2))
    assert [len(b) for b in batches] == [3, 1]
    assert batches[0].dtype == np.float32 and 0.0 <= batches[0].min() <= batches[0].max() <= 1.0


def test_state_from_modules_reads_the_jax_npz_set(setup):
    cfg, model, _, weights, _ = setup
    loaded = eigen.state_from_modules(cfg, weights, EPOCH, device="cpu")
    want = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[key], value), key
    assert not loaded.training


def test_state_from_modules_without_pose_modules(setup, tmp_path, capsys):
    cfg, model, _, weights, _ = setup
    for name in ("encoder", "decoder"):
        os.symlink(os.path.join(weights, f"{name}{EPOCH}.npz"),
                   tmp_path / f"{name}{EPOCH}.npz")
    loaded = eigen.state_from_modules(cfg, str(tmp_path), EPOCH, device="cpu")
    out = capsys.readouterr().out
    jcfg = JConfig(**KW)
    jeigen.state_from_modules(jcfg, str(tmp_path), EPOCH)
    # the same messages as JAX (which walks its modules in another order)
    assert sorted(out.splitlines()) == sorted(capsys.readouterr().out.splitlines())
    assert f">>> pose_encoder{EPOCH}.npz not found; leaving pose_encoder at init" in out
    assert torch.equal(loaded.decoder.decoder[0].conv.conv.weight,
                       model.decoder.decoder[0].conv.conv.weight)
    init = build_model(cfg, device="cpu")
    assert torch.equal(loaded.pose_encoder.conv1.weight, init.pose_encoder.conv1.weight)
    os.remove(tmp_path / f"encoder{EPOCH}.npz")
    with pytest.raises(FileNotFoundError, match="encoder"):
        eigen.state_from_modules(cfg, str(tmp_path), EPOCH, device="cpu")


@pytest.mark.parametrize("spec", ["runs/mono:22", "a:b/c:7", "dir:x", "nocolon", "d:"])
def test_parse_weights_spec_as_jax(spec):
    try:
        want = jeigen.parse_weights_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            eigen.parse_weights_spec(spec)
        return
    assert eigen.parse_weights_spec(spec) == want


def test_detect_scales_as_jax(setup, tmp_path):
    _, _, _, weights, _ = setup
    assert eigen.detect_scales(weights, EPOCH) == jeigen.detect_scales(weights, EPOCH) == (0, 1)
    assert eigen.detect_scales(str(tmp_path), EPOCH) is None
    assert jeigen.detect_scales(str(tmp_path), EPOCH) is None


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("scales", [(0, 1), (0, 1, 2, 3)])
def test_torch_import_then_jax_import_round_trips(scales):
    """state_dict -> the port's torch_import (equal to JAX's) -> npz keys
    (equal to JAX's flattening) -> jax_import: the same tensors, bit for
    bit (num_batches_tracked comes back 0)."""
    cfg = Config(**{**KW, "scales": scales})
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=1)
    sd = {k: v.numpy() for k, v in model.state_dict().items() if v.ndim >= 1}
    enc = torch_import.resnet_encoder_variables(_sub(sd, "encoder."), 18)
    penc = torch_import.resnet_encoder_variables(_sub(sd, "pose_encoder."), 18, 2)
    params = {"encoder": enc["params"], "pose_encoder": penc["params"],
              "decoder": torch_import.depth_decoder_params(_sub(sd, "decoder."), scales),
              "pose_decoder": torch_import.pose_decoder_params(_sub(sd, "pose_decoder."))}
    variables = {"params": params, "batch_stats": {"encoder": enc["batch_stats"],
                                                   "pose_encoder": penc["batch_stats"]}}
    theirs = flax_variables(model.state_dict(), cfg)
    flat = serialization.tree_to_flat(variables)
    assert list(flat) == list(jserialization.tree_to_flat(theirs))
    for key, value in jserialization.tree_to_flat(theirs).items():
        np.testing.assert_array_equal(flat[key], value)
    back = state_dict_from_jax(serialization.flat_to_tree(flat), cfg)
    for key, value in model.state_dict().items():
        want = torch.zeros_like(value) if key.endswith("num_batches_tracked") else value
        assert torch.equal(back[key], want), key
    assert list(module_state_dict("decoder", params["decoder"], None, 18, scales)) == \
        [k for k in back if k.startswith("decoder.")]


def test_npz_files_read_across_packages(setup, tmp_path):
    _, _, variables, *_ = setup
    tree = {"params": variables["params"]["encoder"],
            "batch_stats": variables["batch_stats"]["encoder"], "empty": {}}
    serialization.save_npz(str(tmp_path / "ours.npz"), tree)
    jserialization.save_npz(str(tmp_path / "theirs.npz"), tree)
    ours, theirs = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "theirs.npz")
    assert ours.files == theirs.files and len(ours.files) > 10
    for key in ours.files:
        np.testing.assert_array_equal(ours[key], theirs[key])
    back = jserialization.load_npz(str(tmp_path / "ours.npz"))
    assert back.keys() == {"params", "batch_stats"}
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_convert_torch_weights_monodepth2(tmp_path):
    """Official-layout encoder.pth/depth.pth -> the port's tool and JAX's
    tool write the same npz contents; both CLIs' readers load them."""
    cfg = Config(**{**KW, "scales": (0, 1, 2, 3)})
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=3)
    src = tmp_path / "pth"
    os.makedirs(src)
    torch.save({**{f"encoder.{k}": v for k, v in model.encoder.state_dict().items()},
                "height": 64, "width": 96}, src / "encoder.pth")
    torch.save(model.decoder.state_dict(), src / "depth.pth")
    ours = convert_torch_weights.convert_monodepth2(str(src), str(tmp_path / "a"), 0, 18)
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import convert_torch_weights as jconvert
    finally:
        sys.path.remove(str(ROOT / "tools"))
    theirs = jconvert.convert_monodepth2(str(src), str(tmp_path / "b"), 0, 18)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs] \
        == ["encoder0.npz", "decoder0.npz"]
    for a, b in zip(ours, theirs):
        fa, fb = np.load(a), np.load(b)
        assert fa.files == fb.files
        for key in fa.files:
            np.testing.assert_array_equal(fa[key], fb[key])
    loaded = eigen.state_from_modules(cfg, str(tmp_path / "a"), 0, device="cpu")
    for key, value in model.state_dict().items():
        if key.split(".")[0] in ("encoder", "decoder") and "num_batches" not in key:
            assert torch.equal(loaded.state_dict()[key], value), key


def _cli_args(setup, out):
    cfg, _, _, weights, splits = setup
    return ["--datapath", cfg.datapath, "--splits", splits, "--height", "64",
            "--width", "96", "--eval_batch", "3", "--weights", f"{weights}:{EPOCH}",
            "--save_pred_disps", out, "--gt_cache", ""]


def test_cli_metrics_equal_jax_model_test(setup, tmp_path, monkeypatch, capsys):
    """Both CLIs on the same npz set, run in f32 (their Config with
    precision="f32"; the CLIs have no precision flag), the JAX one on one
    device: the saved disparities at rtol 1e-4, their metrics at rtol
    1e-4, the printed tables equal."""
    ours_out, theirs_out = str(tmp_path / "ours.npy"), str(tmp_path / "theirs.npy")
    monkeypatch.setattr(model_test, "Config", functools.partial(Config, precision="f32"))
    monkeypatch.setattr(jmodel_test, "Config", functools.partial(JConfig, precision="f32"))
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    model_test.main(_cli_args(setup, ours_out) + ["--device", "cpu"])
    ours_text = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["model_test.py"] + _cli_args(setup, theirs_out))
    jmodel_test.main()
    theirs_text = capsys.readouterr().out
    ours, theirs = np.load(ours_out), np.load(theirs_out)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    gts = eigen.load_ground_truth(setup[0].datapath, LINES)
    a, b = eigen.eigen_metrics(ours, gts), jeigen.eigen_metrics(theirs, gts)
    np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=1e-4)
    assert ours_text.replace(ours_out, "") == theirs_text.replace(theirs_out, "")
    assert ">>> Testset length 4" in ours_text and "abs_rel" in ours_text


def test_cli_runs_as_a_module_on_the_cpu(setup, tmp_path):
    """`python -m monodepth_tpu_torch.model_test --device cpu` (default
    precision) prints the table of the disparities it saved; without a
    card and without --device cpu it raises."""
    out = str(tmp_path / "disps.npy")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "monodepth_tpu_torch.model_test", *_cli_args(setup, out)]
    done = subprocess.run(cmd + ["--device", "cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.splitlines()
    disps = np.load(out)
    assert disps.shape == (4, 64, 96) and np.isfinite(disps).all()
    metrics = eigen.eigen_metrics(disps, eigen.load_ground_truth(setup[0].datapath, LINES))
    row = ">>>" + ("   {:4.3f}  " * 7).format(*metrics.values())
    assert lines[:2] == [">>> Testset length 4", ">>> Loaded ground truth depth"]
    assert lines[-3:] == [f">>> {setup[3]}:{EPOCH}",
                          ">>>   abs_rel   sqrt_rel  rmse      rmse_log  a1        a2        a3",
                          row]
    if torch.cuda.is_available():
        return
    failed = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                            text=True, timeout=300)
    assert failed.returncode != 0 and "no CUDA device" in failed.stderr
    assert "abs_rel" not in failed.stdout
