"""The port's pose wirings against the JAX package's, from one seeded init:
`shared`, `posecnn`, `pose_frames="all"` and the stereo frame "s".

- forward parity at 32x64, batch 2, in eval mode (random positive running
  statistics) and in train mode (batch statistics), for `shared`,
  `posecnn`, `separate`/"all", `shared`/"all", `posecnn`/"all" and
  `shared` with "s": disparities and poses rtol 1e-3 with atol 1e-4 /
  1e-5 (tests/test_torch_models.py's bounds), and in train mode the
  batch-norm running statistics after the forward against
  `JMonodepth.apply(..., mutable=["batch_stats"])`, atol 2e-5: the two
  sides sum in another order, through up to 18 layers that normalize as
  few as 4 values a channel (measured 2.6e-6 to 4.7e-6, of values up to
  1.8; `shared` normalizes over B·F images);
- the weight converters for every wiring, both directions, f32 and f64:
  `state_dict_from_jax(flax_variables(sd))` and
  `state_dict_from_jax(jax_variables(sd))` give `sd` back bit for bit, and
  `jax_variables` equals the JAX package's converters' tree;
  `module_state_dict` per module and `optimizer_state_from_jax` too;
- `module_grads` covers every parameter of each wiring; `load_pretrained`
  tiles conv1 over `num_pose_frames` images for `separate` and loads no
  pose net for `shared` or `posecnn`.
The f64 train steps of two wirings are in tests/test_torch_wirings_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth_tpu.models import Monodepth as JMonodepth
from monodepth_tpu.models.pose_decoder import PoseCNN as JPoseCNN
from monodepth_tpu.utils import torch_import
from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.models.monodepth import MODULES, Monodepth, model_modules
from monodepth_tpu_torch.models.pose_decoder import PoseCNN
from monodepth_tpu_torch.training.loop import load_pretrained
from monodepth_tpu_torch.training.state import build_model, module_grads
from monodepth_tpu_torch.utils.jax_export import jax_variables
from monodepth_tpu_torch.utils.jax_import import (
    module_state_dict,
    optimizer_state_from_jax,
    state_dict_from_jax,
)
from torch_parity import flax_variables, one_thread, randomize_bn_stats  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

WIRINGS = {
    "shared": dict(pose_type="shared"),
    "posecnn": dict(pose_type="posecnn"),
    "separate_all": dict(pose_frames="all"),
    "shared_all": dict(pose_type="shared", pose_frames="all"),
    "posecnn_all": dict(pose_type="posecnn", pose_frames="all"),
    "shared_stereo": dict(pose_type="shared", frame_ids=(0, -1, 1, "s")),
}
# every wiring of the converters' tests, the separate default included
ALL_WIRINGS = {"separate": {}, **WIRINGS,
               "separate_stereo": dict(frame_ids=(0, -1, 1, "s"))}


def _cfg(wiring, **kw):
    return Config(height=32, width=64, batch=2, precision="f32",
                  **ALL_WIRINGS[wiring], **kw).validate()


def _model(cfg, dtype=torch.float32):
    model = build_model(cfg, device="cpu")
    randomize_bn_stats(model, seed=1)
    return model.to(dtype)


def _jmodel(cfg):
    return JMonodepth(num_layers=cfg.num_layers, scales=cfg.scales,
                      frame_ids=cfg.frame_ids, pose_type=cfg.pose_type,
                      pose_frames=cfg.pose_frames)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("wiring", WIRINGS)
def test_forward_matches_flax(rng, wiring, train):
    cfg = _cfg(wiring)
    model = _model(cfg)
    variables = flax_variables(model.state_dict(), cfg)
    frames = rng.uniform(0, 1, (2, len(cfg.frame_ids), 32, 64, 3)).astype(np.float32)
    jmodel = _jmodel(cfg)
    if train:
        (their_disps, their_poses), mutated = jmodel.apply(
            variables, jnp.asarray(frames), train=True, mutable=["batch_stats"])
        model.train()
    else:
        their_disps, their_poses = jmodel.apply(variables, jnp.asarray(frames),
                                                train=False)
        model.eval()
    with torch.no_grad():
        disps, poses = model(torch.from_numpy(frames))
    for s in cfg.scales:
        np.testing.assert_allclose(disps[s].numpy(), np.asarray(their_disps[s]),
                                   rtol=1e-3, atol=1e-4)
    sources = [f for f in cfg.frame_ids[1:] if f != "s"]
    assert list(poses) == list(their_poses) == sources
    for fid in sources:
        for a, b in zip(poses[fid], their_poses[fid]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)
    if train:
        ours = _flat(flax_variables(model.state_dict(), cfg)["batch_stats"])
        theirs = _flat(jax.device_get(mutated["batch_stats"]))
        assert ours.keys() == theirs.keys() and len(ours) > 0
        moved = 0.0
        for key, value in theirs.items():
            np.testing.assert_allclose(ours[key], value, rtol=0, atol=2e-5,
                                       err_msg=key)
            moved = max(moved, float(np.abs(value - _flat(variables["batch_stats"])[key]).max()))
        assert moved > 1e-3  # the statistics did update


@pytest.mark.parametrize("wiring", ALL_WIRINGS)
def test_invert_rule(wiring):
    """Past frames invert in pairs mode; nothing inverts in "all" mode."""
    model = Monodepth(**ALL_WIRINGS[wiring])
    inverted = [model.invert_for_frame(f) for f in (-1, 1)]
    assert inverted == ([False, False] if model.pose_frames == "all" else [True, False])


def test_posecnn_matches_flax(rng):
    """`PoseCNN(3)` on channel-stacked frames: ReLU after every conv, x0.01."""
    with torch.random.fork_rng():
        torch.manual_seed(3)
        net = PoseCNN(3).eval()
    assert [k for k in net.state_dict()][-2:] == ["pose_conv.weight", "pose_conv.bias"]
    params = torch_import.pose_cnn_params({k: v.numpy() for k, v in net.state_dict().items()})
    x = rng.uniform(0, 1, (2, 64, 96, 9)).astype(np.float32)
    theirs = JPoseCNN(3).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        ours = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (2, 2, 1, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wiring", ALL_WIRINGS)
def test_weights_round_trip_bit_exact(wiring, dtype):
    cfg = _cfg(wiring)
    sd = _model(cfg, dtype).state_dict()
    theirs = flax_variables(sd, cfg)
    ours = jax_variables(sd, cfg.num_layers, cfg.scales)
    flat_ours, flat_theirs = _flat(ours), _flat(theirs)
    assert flat_ours.keys() == flat_theirs.keys()
    for key, value in flat_theirs.items():
        assert flat_ours[key].dtype == value.dtype and np.array_equal(flat_ours[key], value), key
    for variables in (theirs, ours):
        back = state_dict_from_jax(variables, cfg)
        assert list(back) == list(sd)
        for key in sd:
            assert back[key].dtype == sd[key].dtype and torch.equal(back[key], sd[key]), key
    for name in model_modules(Monodepth(**ALL_WIRINGS[wiring])):
        part = module_state_dict(name, theirs["params"][name],
                                 theirs["batch_stats"].get(name), cfg.num_layers,
                                 cfg.scales)
        assert list(part) == [k for k in sd if k.split(".")[0] == name]
        assert all(torch.equal(part[k], sd[k]) for k in part)


@pytest.mark.parametrize("wiring", ["posecnn", "shared_all", "separate_all"])
def test_optimizer_state_from_jax(wiring):
    """optax Adam's mu and nu land on each parameter of the wiring."""
    cfg = _cfg(wiring)
    model = _model(cfg)
    params = flax_variables(model.state_dict(), cfg)["params"]
    tx = optax.adam(1e-4)
    state = tx.init(params)
    mu = jax.tree.map(lambda a: a + 1.0, params)
    nu = jax.tree.map(lambda a: a * a, params)
    state = (state[0]._replace(count=jnp.asarray(3), mu=mu, nu=nu),) + tuple(state[1:])
    sd = optimizer_state_from_jax(state, model)
    optimizer = torch.optim.Adam(model.parameters())
    optimizer.load_state_dict(sd)
    for (name, p), entry in zip(model.named_parameters(), optimizer.state_dict()["state"].values()):
        assert torch.equal(entry["exp_avg"], p.detach() + 1.0), name
        assert torch.equal(entry["exp_avg_sq"], p.detach() * p.detach()), name
        assert float(entry["step"]) == 3


@pytest.mark.parametrize("wiring", ALL_WIRINGS)
def test_module_grads_cover_every_parameter_of_each_wiring(wiring):
    """`model_modules` names the modules the wiring has, and `module_grads`
    splits every parameter's gradient into exactly one of them."""
    model = build_model(_cfg(wiring), device="cpu")
    expected = tuple(m for m in MODULES if m != "pose_encoder"
                     or model.pose_type == "separate")
    assert model_modules(model) == expected
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, float(i))
    grads = module_grads(model)
    assert tuple(grads) == expected
    assert sum(g.numel() for g in grads.values()) == sum(p.numel() for p in model.parameters())
    assert sum(float(g.sum()) for g in grads.values()) == sum(
        float(p.grad.double().sum()) for p in model.parameters())


@pytest.mark.parametrize("wiring", ["separate_all", "shared", "posecnn"])
def test_load_pretrained_per_wiring(tmp_path, wiring):
    """A torchvision `resnet18.pth` goes into the encoder; the `separate`
    pose encoder gets it with conv1 tiled over its `num_pose_frames` images
    and divided by their count (3 in "all" mode); `shared` and `posecnn`
    have no pose encoder, and their pose decoders stay at init."""
    cfg = _cfg(wiring, weight_init=True, pretrained_dir=str(tmp_path))
    with torch.random.fork_rng():
        torch.manual_seed(5)
        sd = {k: torch.randn_like(v) if v.is_floating_point() else v
              for k, v in build_model(cfg, device="cpu").encoder.state_dict().items()}
    torch.save(sd, tmp_path / "resnet18.pth")
    model = build_model(cfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained(cfg, model) == str(tmp_path / "resnet18.pth")
    own = model.state_dict()
    n = cfg.num_pose_frames
    for key, value in sd.items():
        assert torch.equal(own[f"encoder.{key}"], value), key
        if cfg.pose_type == "separate":
            want = torch.cat([value] * n, 1) / n if key == "conv1.weight" else value
            assert torch.equal(own[f"pose_encoder.{key}"], want), key
    assert own["pose_encoder.conv1.weight"].shape[1] == 9 if wiring == "separate_all" \
        else "pose_encoder.conv1.weight" not in own
    for key in own:
        if key.startswith("pose_decoder") or key.startswith("decoder"):
            assert torch.equal(own[key], init[key]), key


def test_train_cli_flags_reach_the_trainer(monkeypatch):
    """`python -m monodepth_tpu_torch.model_train --pose_type posecnn
    --pose_frames all --dataset kitti_stereo`: the Trainer gets those
    fields unchanged, with "s" added to the frames by `validate`."""
    from monodepth_tpu_torch import model_train

    seen = {}

    class Trainer:
        def __init__(self, cfg, device=None):
            seen["cfg"], seen["device"] = cfg.validate(), device

        def train(self):
            return "trained"

    monkeypatch.setattr(model_train, "Trainer", Trainer)
    assert model_train.main(["--device", "cpu", "--pose_type", "posecnn",
                             "--pose_frames", "all", "--dataset", "kitti_stereo"]) == "trained"
    cfg = seen["cfg"]
    assert (cfg.pose_type, cfg.pose_frames, cfg.dataset) == ("posecnn", "all", "kitti_stereo")
    assert cfg.frame_ids == (0, -1, 1, "s") and seen["device"] == "cpu"
    assert Monodepth(pose_type=cfg.pose_type, pose_frames=cfg.pose_frames,
                     frame_ids=cfg.frame_ids).num_pose_frames == 3
