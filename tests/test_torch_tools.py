"""The port's user tools against the JAX package's, on the CPU: the
colormap helpers, the trajectory error, the pose export and the
single-image inference on one synthetic KITTI tree and one set of weights
(a seeded port model carried into the JAX tree with
`torch_parity.flax_variables`, written as the JAX package's npz exports),
ResNet-18 at 64x96, scales (0, 1), f32 (both packages' tools build their
Config in f32 here: they have no precision flag); and the `torch.export`
artifact of the infer step.

- `colormap_disparity` and `side_by_side` bit for bit, with matplotlib
  and with the inline LUT;
- `snippet_ate` equal;
- `export_poses` and `infer_image` at rtol 1e-4 (two JAX compiles), and
  `export_poses` at its default precision (bf16) too;
- `export_inference`: the saved program, loaded back, equals
  `make_infer_step` at atol 1e-6 for batches 1 and 3 (dynamic batch)."""

import builtins
import functools
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import monodepth_tpu.config as jconfig_module
import monodepth_tpu.utils.visualize as jvisualize
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import kitti
from monodepth_tpu_torch.data.synthetic import DRIVE, make_kitti_tree
from monodepth_tpu_torch.evaluation.eigen import state_from_modules
from monodepth_tpu_torch.tools import evaluate_poses, export_inference, export_poses, \
    infer_image
from monodepth_tpu_torch.training.state import MODULES, build_model
from monodepth_tpu_torch.training.step import make_infer_step
from monodepth_tpu_torch.utils import visualize
from monodepth_tpu.utils import serialization as jserialization
from torch_parity import flax_variables, one_thread, randomize_bn_stats

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import tools.evaluate_poses as jevaluate_poses  # noqa: E402
import tools.export_poses as jexport_poses  # noqa: E402
import tools.infer_image as jinfer_image  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")

KW = dict(height=64, width=96, scales=(0, 1), num_layers=18, weight_init=False)
EPOCH = 1
LINES = [f"{DRIVE} {i} l" for i in range(1, 6)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(datapath, splits dir, weights dir, work dir)."""
    base = tmp_path_factory.mktemp("tools")
    root = make_kitti_tree(str(base / "kitti"), num_frames=7, seed=2, image_hw=(96, 320))
    splits = base / "splits"
    os.makedirs(splits / "kitti_eigen_zhou")
    kitti.savelines(LINES, str(splits / "kitti_eigen_zhou" / "test_files.txt"))
    cfg = Config(**KW)
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=3)
    variables = flax_variables(model.state_dict(), cfg)
    weights = base / "weights"
    os.makedirs(weights)
    for name in MODULES:
        tree = {"params": variables["params"][name]}
        if name in variables["batch_stats"]:
            tree["batch_stats"] = variables["batch_stats"][name]
        jserialization.save_npz(str(weights / f"{name}{EPOCH}.npz"), tree)
    return root, str(splits), str(weights), base


@pytest.fixture
def f32(monkeypatch):
    """Both packages' tools build their Config in f32."""
    monkeypatch.setattr(jconfig_module, "Config",
                        functools.partial(jconfig_module.Config, precision="f32"))
    for tool in (export_poses, infer_image):
        monkeypatch.setattr(tool, "Config", functools.partial(Config, precision="f32"))


def _disparities():
    rng = np.random.default_rng(1)
    return [np.abs(rng.normal(size=(24, 40))).astype(np.float32),
            rng.uniform(0.01, 0.3, (64, 96)).astype(np.float32),
            np.zeros((8, 8), np.float32)]


@pytest.mark.parametrize("lut", [False, True], ids=["matplotlib", "inline_lut"])
def test_colormap_helpers_equal_jax(lut, monkeypatch):
    if lut:  # no matplotlib: both fall back to the inline magma table
        real_import = builtins.__import__

        def no_matplotlib(name, *args, **kwargs):
            if name.startswith("matplotlib"):
                raise ImportError(name)
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_matplotlib)
        monkeypatch.setattr(visualize, "_LUT", None)
        monkeypatch.setattr(jvisualize, "_LUT", None)
    for disp in _disparities():
        ours = visualize.colormap_disparity(disp)
        assert ours.dtype == np.uint8 and ours.shape == disp.shape + (3,)
        np.testing.assert_array_equal(ours, jvisualize.colormap_disparity(disp))
        image = np.full(disp.shape + (3,), 7, np.uint8)
        np.testing.assert_array_equal(visualize.side_by_side(image, disp),
                                      jvisualize.side_by_side(image, disp))
    if lut:
        np.testing.assert_array_equal(visualize._LUT, jvisualize._LUT)


def test_snippet_ate_equals_jax():
    rng = np.random.default_rng(0)
    poses = [np.eye(4)]
    for _ in range(11):
        step = np.eye(4)
        step[:3, 3] = [0.01 * rng.normal(), 0.0, 0.5 + 0.1 * rng.normal()]
        poses.append(poses[-1] @ step)
    gt = np.stack(poses).astype(np.float32)
    noisy = gt.copy()
    noisy[:, :3, 3] += rng.normal(0, 0.2, (12, 3))
    for pred, length in ((gt, 5), (noisy, 5), (noisy, 3)):
        assert evaluate_poses.snippet_ate(pred, gt, length) == \
            jevaluate_poses.snippet_ate(pred, gt, length)
    with pytest.raises(ValueError, match="at least"):
        evaluate_poses.snippet_ate(gt[:3], gt[:3])


def test_export_poses_equals_jax(setup, tmp_path, monkeypatch, f32, capsys):
    """Both tools over the split's 4 consecutive pairs (batches of 3, the
    last ragged): [5, 4, 4] f32 camera-to-world poses at rtol 1e-4 (atol
    1e-6 for the entries near 0); `evaluate_poses` reads them."""
    root, splits, weights, _ = setup
    flags = ["--datapath", root, "--splits", splits, "--weights", f"{weights}:{EPOCH}",
             "--height", "64", "--width", "96", "--batch", "3"]
    ours = export_poses.main(flags + ["--out", str(tmp_path / "ours.npy"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["export_poses.py", *flags,
                                      "--out", str(tmp_path / "theirs.npy")])
    jexport_poses.main()
    theirs = np.load(tmp_path / "theirs.npy")
    assert ours.shape == theirs.shape == (5, 4, 4) and ours.dtype == np.float32
    np.testing.assert_array_equal(np.load(tmp_path / "ours.npy"), ours)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-6)
    assert not np.allclose(ours[-1], np.eye(4))  # the poses moved
    monkeypatch.setattr(export_poses, "Config", Config)  # the default precision, bf16
    bf16 = export_poses.main(flags + ["--out", str(tmp_path / "bf16.npy"), "--device", "cpu"])
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["evaluate_poses", str(tmp_path / "ours.npy"),
                                      str(tmp_path / "theirs.npy"), "--length", "3"])
    evaluate_poses.main()
    assert capsys.readouterr().out.startswith(">>> Trajectory error: 0.0000")


def test_infer_image_equals_jax(setup, tmp_path, monkeypatch, f32):
    """Both tools on one 120x200 image: the depth .npy at rtol 1e-4, the
    disparity PNG at the input's size, equal but for a pixel's rounding
    (the colormap of disparities 1e-4 apart; measured: equal)."""
    *_, weights, _ = setup
    rng = np.random.default_rng(4)
    paths = {}
    for side in ("ours", "theirs"):
        os.makedirs(tmp_path / side)
        paths[side] = str(tmp_path / side / "photo.png")
        Image.fromarray(rng.integers(0, 255, (120, 200, 3), np.uint8)
                        if side == "ours" else np.asarray(Image.open(paths["ours"]))) \
            .save(paths[side])
    flags = ["--weights", f"{weights}:{EPOCH}", "--height", "64", "--width", "96"]
    out = infer_image.main([paths["ours"], *flags, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["infer_image.py", paths["theirs"], *flags])
    jinfer_image.main()
    depth = {s: np.load(tmp_path / s / "photo_depth.npy") for s in paths}
    assert depth["ours"].shape == (64, 96) and depth["ours"].dtype == np.float32
    np.testing.assert_array_equal(depth["ours"], out[paths["ours"]][1])
    np.testing.assert_allclose(depth["ours"], depth["theirs"], rtol=1e-4)
    png = {s: np.asarray(Image.open(tmp_path / s / "photo_disp.png")) for s in paths}
    assert png["ours"].shape == (120, 200, 3)
    assert np.abs(png["ours"].astype(int) - png["theirs"].astype(int)).max() <= 8
    assert (png["ours"] != png["theirs"]).any(-1).mean() < 0.01


def test_export_inference_round_trips(setup, tmp_path):
    """The CLI's `torch.export` artifact (f32, dynamic batch), loaded back
    with `torch.export.load`, equals `make_infer_step` on the same weights
    at atol 1e-6 for batches 1 and 3."""
    *_, weights, _ = setup
    out = str(tmp_path / "depth.pt2")
    export_inference.main(["--weights", f"{weights}:{EPOCH}", "--height", "64",
                           "--width", "96", "--precision", "f32", "--device", "cpu",
                           "--out", out])
    program = torch.export.load(out).module()
    cfg = Config(**KW, precision="f32")
    infer = make_infer_step(state_from_modules(cfg, weights, EPOCH, "cpu"), cfg, "cpu")
    rng = np.random.default_rng(5)
    for b in (1, 3):
        images = torch.from_numpy(rng.random((b, 64, 96, 3), dtype=np.float32))
        with torch.no_grad():
            got = program(images)
        assert got.shape == (b, 64, 96)
        torch.testing.assert_close(got, infer(images), rtol=0, atol=1e-6)
