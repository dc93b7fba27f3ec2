"""The port's KITTI host data path against the JAX package's, bit for bit,
on one synthetic KITTI tree (numpy and PIL on both sides; no JAX compile):
the tree and split files, calibration, velodyne GT, the resizes, the
stereo extrinsic, `KittiDataset.sample` (mono, stereo, training or not,
native decoder or PIL, GT and frame caches), `Loader.epoch` (shuffle, two
epochs, drop_last both ways, per-rank slices) and `prefetch_to_device`
on the CPU."""

import filecmp
import os
import pathlib

import numpy as np
import pytest
import torch

from monodepth_tpu import native as jnative
from monodepth_tpu.data import kitti as jkitti
from monodepth_tpu.data import synthetic as jsynthetic
from monodepth_tpu.data.dataset import KittiDataset as JKittiDataset
from monodepth_tpu.data.pipeline import Loader as JLoader
from monodepth_tpu_torch import native
from monodepth_tpu_torch.data import kitti, synthetic
from monodepth_tpu_torch.data.dataset import KittiDataset
from monodepth_tpu_torch.data.pipeline import Loader, prefetch_to_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
FRAMES = 8
HW = (64, 160)  # resized from the tree's 96x320
MONO, STEREO = (0, -1, 1), (0, -1, 1, "s")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(port tree, JAX tree): the same arguments through both packages."""
    out = []
    for make in (synthetic, jsynthetic):
        root = str(tmp_path_factory.mktemp("kitti"))
        make.make_kitti_tree(root, num_frames=FRAMES, seed=3, image_hw=(96, 320))
        make.make_split_files(root, num_frames=FRAMES)
        out.append(root)
    return out


def _lines(root, split="train"):
    return kitti.readlines(os.path.join(root, "splits", "kitti_eigen_zhou",
                                        f"{split}_files.txt"))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*")
                  if p.is_file())


def test_tree_and_splits_are_the_same_bytes(trees):
    ours, theirs = trees
    names = _files(ours)
    assert names == _files(theirs)
    assert len(names) == 3 * FRAMES + 2 + 3  # jpgs, scans, calib, splits
    _, mismatch, errors = filecmp.cmpfiles(ours, theirs, names, shallow=False)
    assert not mismatch and not errors
    assert len(_lines(ours)) == 2 * (FRAMES - 2) - 2


def _scan(root, frame=2):
    return (kitti.calib_dir(root, synthetic.DRIVE),
            kitti.velodyne_path(root, synthetic.DRIVE, frame))


@pytest.mark.parametrize("cam", [2, 3])
@pytest.mark.parametrize("vel_depth", [False, True])
def test_velodyne_to_depth_bit_for_bit(trees, cam, vel_depth):
    calib, velo = _scan(trees[0])
    ours = kitti.velodyne_to_depth(calib, velo, cam=cam, vel_depth=vel_depth)
    theirs = jkitti.velodyne_to_depth(calib, velo, cam=cam, vel_depth=vel_depth)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.shape == (kitti.GT_HEIGHT, kitti.GT_WIDTH)
    assert (ours > 0).sum() > 500
    np.testing.assert_array_equal(ours, theirs)


def test_velodyne_dedup_keeps_the_nearest_return(tmp_path, trees):
    """Two returns on one pixel: the nearer one is kept (np.minimum.at);
    a return elsewhere stays, one behind the sensor is dropped."""
    calib, _ = _scan(trees[0])
    pts = np.array([[10.0, 0.0, 0.0, 1.0], [10.0, 0.0, 0.0, 1.0],
                    [20.0, 2.0, 1.0, 1.0], [-5.0, 0.0, 0.0, 1.0]], np.float32)
    pts[1, 0] = 10.001  # same pixel, a hair farther
    velo = str(tmp_path / "scan.bin")
    pts.tofile(velo)
    ours = kitti.velodyne_to_depth(calib, velo, vel_depth=True)
    np.testing.assert_array_equal(ours, jkitti.velodyne_to_depth(calib, velo, vel_depth=True))
    assert sorted(ours[ours > 0].tolist()) == [10.0, 20.0]


def test_read_calib_file_equals(trees):
    calib, _ = _scan(trees[0])
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        ours = kitti.read_calib_file(os.path.join(calib, name))
        theirs = jkitti.read_calib_file(os.path.join(calib, name))
        assert ours.keys() == theirs.keys()
        for key in ours:
            if isinstance(ours[key], str):
                assert ours[key] == theirs[key]
            else:
                np.testing.assert_array_equal(ours[key], theirs[key])


@pytest.mark.parametrize("shape,out", [((375, 1242), (375, 1242)),
                                       ((370, 1226), (375, 1242)),
                                       ((50, 70), (23, 31))])
def test_resize_nearest_equals(shape, out):
    image = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    np.testing.assert_array_equal(kitti.resize_nearest_np(image, *out),
                                  jkitti.resize_nearest_np(image, *out))


@pytest.mark.parametrize("side", ["l", "r"])
@pytest.mark.parametrize("flip", [False, True])
def test_stereo_transform_and_paths_equal(side, flip):
    np.testing.assert_array_equal(kitti.stereo_transform(side, flip),
                                  jkitti.stereo_transform(side, flip))
    assert kitti.image_path("d", synthetic.DRIVE, 7, side) == \
        jkitti.image_path("d", synthetic.DRIVE, 7, side)
    line = f"{synthetic.DRIVE} 473 {side}"
    assert kitti.parse_split_line(line) == jkitti.parse_split_line(line)
    for K, jK in zip(kitti.intrinsics(*HW), jkitti.intrinsics(*HW)):
        np.testing.assert_array_equal(K, jK)


def test_split_file_helpers(tmp_path):
    path = str(tmp_path / "files.txt")
    kitti.savelines(["a 1 l", "b 2 r", "c 3 l"], path)
    assert kitti.readlines(path) == jkitti.readlines(path) == ["a 1 l", "b 2 r", "c 3 l"]
    assert kitti.removelines(path, lambda ln: ln.endswith("r")) == ["a 1 l", "c 3 l"]
    assert jkitti.readlines(path) == ["a 1 l", "c 3 l"]


def _natives():
    """use_native settings both packages can run here."""
    return [False, True] if native.available() and jnative.available() else [False]


def test_native_decoder_builds_under_build_native():
    if not native.available():
        pytest.skip("no g++ or libjpeg here: the dataset decodes with PIL")
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("frame_ids", [MONO, STEREO, (0, "s")], ids=["mono", "mono+stereo", "stereo"])
def test_sample_bit_for_bit(trees, frame_ids, training, use_native):
    if use_native not in _natives():
        pytest.skip("the native decoder does not build here")
    root = trees[0]
    lines = _lines(root)
    kw = dict(is_training=training, frame_ids=frame_ids, height=HW[0], width=HW[1],
              use_native=use_native)
    ours, theirs = KittiDataset(root, lines, **kw), JKittiDataset(root, lines, **kw)
    jittered = set()
    for index in range(len(lines)):
        a = ours.sample(index, np.random.default_rng((5, index)))
        b = theirs.sample(index, np.random.default_rng((5, index)))
        assert a.keys() == b.keys()
        assert ("stereo_T" in a) == ("s" in frame_ids)
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        jittered.add(bool(a["jitter"][0]))
    assert a["frames"].shape == (len(frame_ids), *HW, 3)
    assert jittered == ({True, False} if training else {False})


@pytest.mark.parametrize("use_native", [False, True])
def test_sample_caches_bit_for_bit(trees, tmp_path, use_native):
    """The GT and frame caches: first pass writes, second pass reads, both
    equal to the JAX package's dataset with its own caches (same keys)."""
    if use_native not in _natives():
        pytest.skip("the native decoder does not build here")
    root = trees[0]
    lines = _lines(root)
    kw = dict(is_training=True, frame_ids=MONO, height=HW[0], width=HW[1],
              use_native=use_native)
    ours = KittiDataset(root, lines, gt_cache_dir=str(tmp_path / "gt"),
                        frame_cache_dir=str(tmp_path / "frames"), **kw)
    theirs = JKittiDataset(root, lines, gt_cache_dir=str(tmp_path / "jgt"),
                           frame_cache_dir=str(tmp_path / "jframes"), **kw)
    for _ in range(2):
        for index in range(len(lines)):
            a = ours.sample(index, np.random.default_rng(index))
            b = theirs.sample(index, np.random.default_rng(index))
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for ours_dir, theirs_dir in (("gt", "jgt"), ("frames", "jframes")):
        names = sorted(os.listdir(tmp_path / ours_dir))
        assert names == sorted(os.listdir(tmp_path / theirs_dir))
        assert names and all(n.endswith(".npy") and ".tmp" not in n for n in names)


def _epochs(loader, epochs=(0, 1)):
    try:
        return [list(loader.epoch(e)) for e in epochs]
    finally:
        loader.close()


def _dataset(pkg, root):
    cls = KittiDataset if pkg == "port" else JKittiDataset
    return cls(root, _lines(root), is_training=True, frame_ids=MONO,
               height=HW[0], width=HW[1], use_native=False)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_epochs_bit_for_bit(trees, shuffle, drop_last):
    root = trees[0]
    kw = dict(batch_size=4, shuffle=shuffle, num_workers=3, seed=9,
              drop_last=drop_last, process_index=0, process_count=1)
    ours = _epochs(Loader(_dataset("port", root), **kw))
    theirs = _epochs(JLoader(_dataset("jax", root), **kw))
    n = len(_lines(root))
    for a_epoch, b_epoch in zip(ours, theirs):
        assert len(a_epoch) == len(b_epoch) == (n // 4 if drop_last else -(-n // 4))
        for a, b in zip(a_epoch, b_epoch):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert len(ours[-1][-1]["frames"]) == (4 if drop_last else n % 4 or 4)
    if shuffle:  # the epochs draw their own order and augmentation
        assert not np.array_equal(ours[0][0]["jitter"], ours[1][0]["jitter"])


def test_loader_rank_slices_compose_to_the_global_batch(trees):
    """2 ranks: each rank's batches equal JAX's for that rank, and the two
    slices stacked are the single-process global batch."""
    root = trees[0]
    kw = dict(batch_size=4, shuffle=True, num_workers=2, seed=3)
    whole = _epochs(Loader(_dataset("port", root), process_index=0,
                           process_count=1, **kw), (1,))[0]
    ranks = []
    for rank in range(2):
        ours = _epochs(Loader(_dataset("port", root), process_index=rank,
                              process_count=2, **kw), (1,))[0]
        theirs = _epochs(JLoader(_dataset("jax", root), process_index=rank,
                                 process_count=2, **kw), (1,))[0]
        for a, b in zip(ours, theirs):
            assert len(a["frames"]) == 2
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        ranks.append(ours)
    assert len(ranks[0]) == len(whole)
    for g, r0, r1 in zip(whole, *ranks):
        for key in g:
            np.testing.assert_array_equal(g[key], np.concatenate([r0[key], r1[key]]))


def test_loader_process_rules(trees):
    ds = _dataset("port", trees[0])
    loader = Loader(ds, 4, shuffle=False)  # no process group: one process
    assert (loader.process_index, loader.process_count) == (0, 1)
    with pytest.raises(ValueError, match="given together"):
        Loader(ds, 4, shuffle=False, process_index=0)
    with pytest.raises(ValueError, match="not divisible"):
        Loader(ds, 3, shuffle=False, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="drop_last"):
        list(Loader(ds, 4, shuffle=False, drop_last=False, process_index=1,
                    process_count=2).epoch(0))


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_on_cpu_yields_every_batch_in_order(trees, size):
    loader = Loader(_dataset("port", trees[0]), 4, shuffle=True, num_workers=2,
                    drop_last=False, process_index=0, process_count=1)
    try:
        want = list(loader.epoch(0))
        got = list(prefetch_to_device(loader.epoch(0), size=size, device="cpu"))
    finally:
        loader.close()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            assert isinstance(a[key], torch.Tensor) and a[key].device.type == "cpu"
            np.testing.assert_array_equal(a[key].numpy(), b[key])


def test_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([{"x": np.zeros(2)}])))
