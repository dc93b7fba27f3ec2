"""The port's modules against the Flax modules from one seed: build the
torch module, convert its state_dict with `monodepth_tpu.utils.
torch_import`, compare forwards (eval-mode BN with random positive
running_var). Tolerances follow tests/test_models.py. Plus the weight
round trip through `monodepth_tpu_torch.utils.jax_import`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth_tpu.models import DepthDecoder as JDepthDecoder
from monodepth_tpu.models import Monodepth as JMonodepth
from monodepth_tpu.models import PoseDecoder as JPoseDecoder
from monodepth_tpu.models import ResNetEncoder as JResNetEncoder
from monodepth_tpu.utils import torch_import
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.models.depth_decoder import DepthDecoder, reflect_pad1
from monodepth_tpu_torch.models.monodepth import Monodepth
from monodepth_tpu_torch.models.pose_decoder import PoseDecoder
from monodepth_tpu_torch.models.resnet import ResNetEncoder, num_ch_enc
from monodepth_tpu_torch.utils.jax_import import state_dict_from_jax
from torch_parity import flax_variables, one_thread, randomize_bn_stats

pytestmark = pytest.mark.usefixtures("one_thread")


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _seeded(make, seed=0):
    """A module built under a fixed seed with torch's default init."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return make().eval()


@pytest.mark.parametrize("num_layers,images", [(18, 1), (18, 2), (50, 1), (34, 1),
                                               (101, 1)])
def test_encoder_matches_flax(rng, num_layers, images):
    enc = _seeded(lambda: ResNetEncoder(num_layers, images))
    randomize_bn_stats(enc)
    enc.eval()
    variables = torch_import.resnet_encoder_variables(
        {k: v.numpy() for k, v in enc.state_dict().items()},
        num_layers, num_input_images=images)
    x = rng.uniform(0, 1, (2, 64, 96, 3 * images)).astype(np.float32)
    theirs = JResNetEncoder(num_layers=num_layers, num_input_images=images
                            ).apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = enc(_nchw(x))
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("H,W", [(64, 96), (32, 128)])
def test_depth_decoder_matches_flax(rng, H, W):
    ch = num_ch_enc(18)
    dec = _seeded(lambda: DepthDecoder(ch))
    params = torch_import.depth_decoder_params(
        {k: v.numpy() for k, v in dec.state_dict().items()})
    feats = [rng.standard_normal((2, H >> s, W >> s, c)).astype(np.float32)
             for s, c in zip([1, 2, 3, 4, 5], ch)]
    theirs = JDepthDecoder().apply({"params": params},
                                   [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        ours = dec([_nchw(f) for f in feats])
    assert set(ours) == set(theirs) == {0, 1, 2, 3}
    for s in ours:
        assert ours[s].dtype == torch.float32
        np.testing.assert_allclose(_nhwc(ours[s]), np.asarray(theirs[s]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nif,nf", [(1, 2), (2, 1)])
def test_pose_decoder_matches_flax(rng, nif, nf):
    ch = num_ch_enc(18)
    pd = _seeded(lambda: PoseDecoder(ch, nif, nf), seed=1)
    params = torch_import.pose_decoder_params(
        {k: v.numpy() for k, v in pd.state_dict().items()})
    feats = [[rng.standard_normal((2, 2, 3, c)).astype(np.float32) for c in ch]
             for _ in range(nif)]
    theirs = JPoseDecoder(nif, nf).apply(
        {"params": params}, [[jnp.asarray(f) for f in fs] for fs in feats])
    with torch.no_grad():
        ours = pd([[_nchw(f) for f in fs] for fs in feats])
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def _monodepth(cfg):
    model = Monodepth(cfg.num_layers, cfg.scales, cfg.frame_ids)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    randomize_bn_stats(model, seed=1)
    return model.eval()


def test_monodepth_forward_matches_flax(rng):
    cfg = Config(height=64, width=96, precision="f32")
    model = _monodepth(cfg)
    variables = flax_variables(model.state_dict(), cfg)
    frames = rng.uniform(0, 1, (2, 3, 64, 96, 3)).astype(np.float32)
    jmodel = JMonodepth(pose_type="separate")
    their_disps, their_poses = jmodel.apply(variables, jnp.asarray(frames),
                                            train=False)
    with torch.no_grad():
        disps, poses = model(torch.from_numpy(frames))
        depth_only = model.depth(torch.from_numpy(frames[:, 0]))
    for s in (0, 1, 2, 3):
        np.testing.assert_allclose(disps[s].numpy(), np.asarray(their_disps[s]),
                                   rtol=1e-3, atol=1e-4)
        assert torch.equal(depth_only[s], disps[s])
    assert set(poses) == set(their_poses) == {-1, 1}
    for fid in poses:
        for a, b in zip(poses[fid], their_poses[fid]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-3, atol=1e-5)
    assert model.invert_for_frame(-1) and not model.invert_for_frame(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weights_round_trip_bit_exact(dtype):
    cfg = Config(precision="f32")
    model = _monodepth(cfg).to(dtype)
    sd = model.state_dict()
    back = state_dict_from_jax(flax_variables(sd, cfg), cfg)
    assert list(back) == list(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype, k
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back)


def test_stages_match_the_jax_table():
    """Every ResNet depth's blocks per stage and block kind (18, 34, 50,
    101, 152), and the pyramid's channel counts, as the JAX package's."""
    from monodepth_tpu.models.resnet import STAGES as JSTAGES
    from monodepth_tpu_torch.models.resnet import STAGES

    assert STAGES == JSTAGES and sorted(STAGES) == [18, 34, 50, 101, 152]
    for num_layers in STAGES:
        enc = ResNetEncoder(num_layers, 1)
        depths = tuple(len(getattr(enc, f"layer{i}")) for i in range(1, 5))
        assert depths == STAGES[num_layers][0]
        assert list(enc.num_ch_enc) == list(num_ch_enc(num_layers))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 4), (1, 2, 3, 1),
                                   (1, 1, 1, 1), (2, 4, 2, 2)])
def test_reflect_pad_matches_numpy(rng, shape):
    """The decoder's pad (slices and a concatenation, deterministic
    backward) is numpy's reflect pad, sides of length 1 included; its
    gradient adds each padded cell's cotangent to the cell it copies."""
    x = torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True)
    out = reflect_pad1(x)
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.pad(x.detach().numpy(), ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect"))
    weight = torch.from_numpy(rng.standard_normal(out.shape))
    (out * weight).sum().backward()
    theirs = jax.grad(lambda a: (jnp.pad(a, ((0, 0), (0, 0), (1, 1), (1, 1)),
                                         mode="reflect") * weight.numpy()).sum())(
        jnp.asarray(x.detach().numpy(), jnp.float32))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)
