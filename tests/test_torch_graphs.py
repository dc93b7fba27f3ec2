"""What the port's CUDA-graph steps rest on, checked on the CPU (the
capture itself runs only on a card: `tests/test_torch_gpu.py`, marked
`gpu`). torch only, one intra-op thread, tiny shapes, no JAX compile.

- the step path's constants live on the device: the cached resize
  matrices, `warp_grid`'s normalisation and the grayscale weights equal
  the expressions they replace bit for bit, and a constant first made
  under inference mode still serves autograd;
- the tie-break noise drawn ahead (`draw_tie_noise`, what a graphed step
  copies into its static buffers) gives the train and eval steps the
  bits of the noise drawn inside the loss, for K = 1 and K = 2, and the
  static inputs of K steps carry the rates schedule(step + k);
- on a `{data: n}` mesh the noise drawn ahead is the global batch's, cut
  to the rank's items as the eager mesh step cuts it;
- `graph=True` raises on the CPU, a gloo mesh and a spatial mesh, and
  `graph=None` captures on a card without a mesh or on an NCCL
  `{data: n}` mesh; `_Meter` keeps its own
  copy of the first value it is handed; a checkpoint written before Adam
  became capturable on the card restores into either kind of Adam.
"""

import copy
import os
import shutil

import numpy as np
import pytest
import torch

from monodepth_tpu_torch.config import Config
from monodepth_tpu_torch.data import augment
from monodepth_tpu_torch.data.synthetic import make_planar_scenes
from monodepth_tpu_torch.ops import geometry, sampling
from monodepth_tpu_torch.parallel.mesh import Mesh, make_mesh
from monodepth_tpu_torch.training import graphs, step as step_module
from monodepth_tpu_torch.training.checkpoint import Checkpointer
from monodepth_tpu_torch.training.loop import _Meter
from monodepth_tpu_torch.training.state import build_model, create_state
from monodepth_tpu_torch.training.step import (
    draw_tie_noise,
    make_eval_step,
    make_infer_step,
    make_train_multi_step,
    make_train_step,
)
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")


def _cfg(**kw):
    base = dict(height=32, width=64, scales=(0, 1), batch=2, precision="f32",
                weight_init=False, learning_rate=1e-3, scheduler_step=1)
    base.update(kw)
    return Config(**base)


def _batch(cfg, seed=0, depth_gt=False):
    """Frames (0, -1, +1) of `make_planar_scenes` in `cfg.frame_ids` order;
    "s" is the +1 view again, with the ground-truth baseline as
    `stereo_T`."""
    scenes = make_planar_scenes(cfg.batch, cfg.height, cfg.width, seed=seed)
    batch = {k: scenes[k] for k in ("frames", "K", "inv_K")}
    batch["frames"] = scenes["frames"][:, [{0: 0, -1: 1, 1: 2, "s": 2}[f]
                                           for f in cfg.frame_ids]]
    if "s" in cfg.frame_ids:
        stereo_T = np.tile(np.eye(4, dtype=np.float32), (cfg.batch, 1, 1))
        stereo_T[:, 0, 3] = scenes["gt_tx"]
        batch["stereo_T"] = stereo_T
    rng = np.random.default_rng(seed)
    batch["jitter"] = np.concatenate(  # jitter on, so the grayscale runs
        [np.ones((cfg.batch, 1)), rng.uniform(0.8, 1.2, (cfg.batch, 3)),
         rng.uniform(-0.1, 0.1, (cfg.batch, 1))], 1).astype(np.float32)
    if depth_gt:
        gt = rng.uniform(1.0, 60.0, (cfg.batch, 375, 1242)).astype(np.float32)
        gt[rng.uniform(size=gt.shape) < 0.9] = 0.0
        batch["depth_gt"] = gt
    return batch


def _state(cfg, steps_per_epoch=1):
    return create_state(cfg, build_model(cfg, device="cpu"),
                        steps_per_epoch=steps_per_epoch)


def _assert_states_equal(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key in sa[i]:
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert a.step == b.step


def _assert_metrics_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


# --- the constants of the step path ------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("align", [False, True])
def test_cached_resize_matrices_equal_the_per_call_ones(dtype, align):
    image = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(2, 6, 10, 3))).to(dtype)
    for height, width in ((12, 20), (3, 5), (375, 1242)):
        def fresh(n_in, n_out):  # the expression each call used to run
            return torch.from_numpy(sampling._linear_resize_matrix(
                n_in, n_out, align)).to(image.device, image.dtype)

        want = torch.einsum("ow,bhwc->bhoc", fresh(10, width),
                            torch.einsum("oh,bhwc->bowc", fresh(6, height), image))
        assert torch.equal(sampling.resize_bilinear(image, height, width, align), want)
        cached = sampling._resize_matrix(6, height, align, dtype, image.device)
        assert torch.equal(cached, fresh(6, height))
        assert sampling._resize_matrix(6, height, align, dtype, image.device) is cached


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_warp_grid_normalisation_equals_the_host_tensor(dtype):
    rng = np.random.default_rng(2)
    B, H, W = 2, 24, 40
    depth = torch.from_numpy(rng.uniform(1.0, 30.0, (B, H, W, 1))).to(dtype)
    K = torch.eye(4, dtype=dtype).repeat(B, 1, 1)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, W / 2, H / 2
    inv_K = torch.linalg.inv(K)
    T = geometry.transform_from_parameters(
        torch.from_numpy(rng.normal(0, 0.02, (B, 1, 3))).to(dtype),
        torch.from_numpy(rng.normal(0, 0.1, (B, 1, 3))).to(dtype))
    grid = geometry.warp_grid(depth, inv_K, K, T)

    # the body of warp_grid with the normalisation it used to build per call
    pix = geometry._homogeneous_pixel_grid(H, W, dtype, depth.device)
    P = (K @ T)[:, :3, :]
    rays = torch.einsum("bij,jn->bin", P[:, :, :3] @ inv_K[:, :3, :3], pix)
    pts = rays * depth[..., 0].reshape(B, 1, H * W) + P[:, :, 3:4]
    xy = (pts[:, :2, :] / (pts[:, 2:3, :] + 1e-7)).reshape(B, 2, H, W).permute(0, 2, 3, 1)
    scale = torch.tensor([W - 1, H - 1], dtype=xy.dtype, device=xy.device)
    assert torch.equal(grid, ((xy / scale - 0.5) * 2.0).contiguous())


def test_grayscale_weights_equal_the_host_tensor():
    img = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 5, 7, 3))
                           ).float()
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    assert torch.equal(augment._grayscale(img), (img * w).sum(-1, keepdim=True))


def test_constants_made_under_inference_mode_serve_autograd():
    """The first use of a shape may be an eval step (inference mode); the
    cached tensor must still be one autograd can save for a train step."""
    sampling.device_constant.cache_clear()
    sampling._resize_matrix.cache_clear()
    image = torch.rand(1, 5, 9, 2, dtype=torch.float64)
    depth = torch.rand(1, 13, 17, 1, dtype=torch.float64) + 1.0
    eye = torch.eye(4, dtype=torch.float64)[None]
    with torch.inference_mode():
        sampling.resize_bilinear(image, 11, 7)
        geometry.warp_grid(depth, eye, eye, eye)
    image.requires_grad_(True)
    depth.requires_grad_(True)
    loss = sampling.resize_bilinear(image, 11, 7).sum() \
        + geometry.warp_grid(depth, eye, eye, eye).sum()
    loss.backward()
    assert image.grad is not None and depth.grad is not None


# --- the noise and rates a graphed step is fed -------------------------

# the wirings whose noise differs in its number of sources: the default
# (-1, +1), stereo ("s" alone), mono+stereo (three) and pose_frames="all"
WIRINGS = {"separate": {}, "stereo": dict(frame_ids=(0, "s")),
           "mono_stereo": dict(frame_ids=(0, -1, 1, "s")),
           "shared_all": dict(pose_type="shared", pose_frames="all")}


@pytest.mark.parametrize("wiring", list(WIRINGS))
def test_train_step_fed_the_predrawn_noise_equals_the_drawing_step(wiring):
    cfg = _cfg(train_gt_metrics=True, **WIRINGS[wiring])
    batch = _batch(cfg, depth_gt=True)
    drawn = _state(cfg)
    fed = copy.deepcopy(drawn)
    a = make_train_step(drawn.model, cfg, device="cpu")(drawn, batch)
    noise = draw_tie_noise(cfg, step_module._host_or_device(batch), fed.seed,
                           fed.step, None, CPU)
    assert sorted(noise) == list(cfg.scales)
    assert all(n.shape[-1] == len(cfg.source_frame_ids) for n in noise.values())
    b = make_train_step(fed.model, cfg, device="cpu")(fed, batch, noise=noise)
    _assert_metrics_equal(a, b)
    assert "abs_rel" in a
    _assert_states_equal(drawn, fed)


@pytest.mark.parametrize("wiring", list(WIRINGS))
def test_eval_step_fed_the_predrawn_noise_equals_the_drawing_step(wiring):
    cfg = _cfg(**WIRINGS[wiring])
    batch = _batch(cfg, depth_gt=True)
    state = _state(cfg)
    state.step = 7
    step = make_eval_step(state.model, cfg, device="cpu")
    a = step(state, batch, 3)
    with torch.inference_mode():
        noise = draw_tie_noise(cfg, step_module._host_or_device(batch), state.seed,
                               state.step, 3, CPU)
    b = step(state, batch, 3, noise=noise)
    _assert_metrics_equal(a, b)
    assert "abs_rel" in a and "warp_span" in a
    other = step(state, batch, 4)  # another batch index draws other noise
    assert not torch.equal(a["loss"], other["loss"])


def test_k_steps_fed_their_static_inputs_equal_the_multi_step():
    """The inputs of 2 captured steps (`_train_inputs`), copied into static
    buffers as `GraphedStep` copies them, hold each batch, the noise of
    steps step and step + 1, and the rates schedule(step + k) as f32; two
    steps fed that noise equal the multi step, which draws its own."""
    cfg = _cfg()
    batches = [_batch(cfg, seed=s) for s in (0, 1)]
    drawn = _state(cfg)
    drawn.step = 1  # the schedule decays at every step here
    fed = copy.deepcopy(drawn)
    inputs = step_module._train_inputs(cfg, fed, batches, None, CPU)
    static = graphs._empty(inputs, CPU)
    graphs._copy_into(static, inputs)
    want_lr = [fed.schedule(fed.step + k) for k in range(2)]
    assert want_lr[0] != want_lr[1]
    for k in range(2):
        assert torch.equal(static["lr"][k], torch.tensor(want_lr[k], dtype=torch.float32))
        for key, value in batches[k].items():
            assert torch.equal(static["batches"][k][key], torch.as_tensor(value)), key
        for s, value in inputs["noise"][k].items():
            assert torch.equal(static["noise"][k][s], value)
    assert not torch.equal(inputs["noise"][0][0], inputs["noise"][1][0])

    stacked = make_train_multi_step(drawn.model, cfg, device="cpu")(drawn, batches)
    single = make_train_step(fed.model, cfg, device="cpu")
    metrics = [single(fed, b, noise=static["noise"][k]) for k, b in enumerate(batches)]
    for key in stacked:
        assert torch.equal(stacked[key], torch.stack([m[key] for m in metrics])), key
    _assert_states_equal(drawn, fed)
    assert fed.step == 3


def test_signatures_key_shapes_dtypes_and_structure():
    a = {"batch": {"x": torch.zeros(2, 3)}, "lr": [1e-4]}
    assert graphs._signature(a) == graphs._signature(
        {"batch": {"x": torch.ones(2, 3)}, "lr": [5e-5]})
    for other in ({"batch": {"x": torch.zeros(3, 3)}, "lr": [1e-4]},
                  {"batch": {"x": torch.zeros(2, 3, dtype=torch.float64)}, "lr": [1e-4]},
                  {"batch": {"y": torch.zeros(2, 3)}, "lr": [1e-4]},
                  {"batch": {"x": torch.zeros(2, 3)}, "lr": [1e-4, 1e-4]}):
        assert graphs._signature(other) != graphs._signature(a)


# --- where graphs run ----------------------------------------------------

def test_graph_true_raises_on_the_cpu_and_on_a_mesh():
    """`graph=True` raises where a step cannot be captured, naming why: the
    CPU (with or without a mesh) and a gloo mesh, spatial or not;
    `graph=None` stays eager there. A mesh over NCCL captures, spatial or
    not (a captured spatial step warps on the gathered rows, with no host
    branch), as does a mesh of one process (no collective). The meshes are
    built directly, with no process group."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    for make in (make_train_step, make_train_multi_step, make_eval_step,
                 make_infer_step):
        with pytest.raises(ValueError, match="graph=True: a CUDA graph needs a CUDA "
                                             "device, not cpu"):
            make(model, cfg, "cpu", graph=True)
    cuda = torch.device("cuda")
    refused = {  # mesh -> what the message names
        "cpu": (make_mesh(1, 1, "cpu"), "needs a CUDA device"),  # run_steps, one process
        "cpu_data": (Mesh(2, 1, 0, CPU, backend="gloo"), "needs a CUDA device"),
        "gloo": (Mesh(2, 1, 1, cuda, backend="gloo"), "over gloo cannot be captured"),
        "no_group": (Mesh(2, 1, 0, cuda), "over no process group"),
        "spatial_gloo": (Mesh(1, 2, 0, cuda, backend="gloo"), "over gloo cannot be "
                                                                "captured"),
        "data_spatial_gloo": (Mesh(2, 2, 3, cuda, backend="gloo"), "over gloo"),
    }
    for name, (mesh, reason) in refused.items():
        for make in (make_train_step, make_train_multi_step, make_eval_step):
            with pytest.raises(ValueError, match="graph=True: .*" + reason):
                make(model, cfg, mesh=mesh, graph=True)
        assert step_module.graph_refusal(mesh.device, mesh) is not None, name
        assert not step_module._graphed(None, mesh.device, mesh), name
        assert not step_module._graphed(False, mesh.device, mesh), name
    for mesh in (Mesh(2, 1, 0, cuda, backend="nccl"), Mesh(4, 1, 3, cuda, backend="nccl"),
                 Mesh(1, 2, 0, cuda, backend="nccl"), Mesh(2, 2, 3, cuda, backend="nccl"),
                 Mesh(1, 1, 0, cuda)):
        assert step_module.graph_refusal(cuda, mesh) is None
        assert step_module._graphed(None, cuda, mesh)
        assert step_module._graphed(True, cuda, mesh)
        assert not step_module._graphed(False, cuda, mesh)
    assert step_module._graphed(None, cuda, None)
    assert not step_module._graphed(None, CPU, None)
    assert not step_module._graphed(False, cuda, None)


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("wiring", ["separate", "mono_stereo"])
@pytest.mark.parametrize("index", [None, 3])
def test_mesh_noise_drawn_ahead_is_the_ranks_cut(data, wiring, index):
    """On a `{data: n}` mesh a graphed step is fed `draw_tie_noise(...,
    mesh)`: the global batch's noise drawn ahead and cut to the rank's
    items. For every data index it equals `_rank_noise`'s draw (the eager
    mesh step's) and the single device's noise of the global batch at the
    rank's items, bit for bit; a global noise handed in is cut the same
    way. Train steps (`index` None) and eval batches."""
    cfg = _cfg(batch=2 * data, **WIRINGS[wiring])
    whole = step_module._host_or_device(_batch(cfg))
    one = draw_tie_noise(cfg, whole, 42, 5, index, CPU)
    for rank in range(data):
        mesh = Mesh(data, 1, rank, CPU, backend="gloo")
        piece = {k: v[2 * rank:2 * rank + 2] for k, v in whole.items()}
        drawn = draw_tie_noise(cfg, piece, 42, 5, index, CPU, mesh)
        eager = step_module._rank_noise(
            step_module.tie_noise_generator(42, 5, index, CPU), piece, cfg, mesh, CPU)
        handed = step_module._rank_noise(one, piece, cfg, mesh, CPU)
        assert sorted(drawn) == sorted(eager) == sorted(handed) == list(cfg.scales)
        for s in cfg.scales:
            assert drawn[s].shape == (2, cfg.height, cfg.width,
                                      len(cfg.source_frame_ids))
            assert torch.equal(drawn[s], eager[s]), (rank, s)
            assert torch.equal(drawn[s], one[s][2 * rank:2 * rank + 2]), (rank, s)
            assert torch.equal(handed[s], drawn[s]), (rank, s)


def test_graphed_step_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.GraphedStep(lambda x: x, CPU, list)


def test_meter_keeps_its_own_copy_of_the_first_value():
    """A captured step's outputs are static buffers that the next replay
    overwrites; `_Meter` must not hold them by reference."""
    meter = _Meter()
    loss, span = torch.tensor(1.0), torch.tensor(3.0)
    meter.update({"loss": loss, "warp_span": span})
    loss.fill_(100.0)
    span.fill_(100.0)
    meter.update({"loss": torch.tensor(2.0), "warp_span": torch.tensor(1.0)})
    stacked = torch.tensor([4.0, 5.0])
    meter.update({"loss": stacked, "warp_span": stacked})
    stacked.fill_(-1.0)
    means = meter.means()
    assert means["loss"] == pytest.approx(3.0)
    assert means["warp_span_max"] == 5.0


# --- checkpoints across the Adam change ---------------------------------

def _capturable_twin(state):
    """`state` with Adam as `make_optimizer` builds it on a card:
    capturable, a tensor rate (its parameters stay on the CPU here, which
    capturable Adam refuses to step, but can load)."""
    twin = copy.deepcopy(state)
    params = list(twin.model.parameters())
    twin.optimizer = torch.optim.Adam(params, lr=torch.full((), 1.0), betas=(0.9, 0.999),
                                      eps=1e-8, foreach=True, capturable=True)
    return twin


@pytest.mark.parametrize("written_by", ["host_adam", "capturable_adam"])
def test_checkpoint_restores_into_either_adam(tmp_path, request, written_by):
    """A state file of the host Adam (every checkpoint before Adam became
    capturable on the card, and the CPU's now) and one in a capturable
    Adam's layout (its rate a tensor, `capturable` set) both restore into
    the host Adam and into a capturable one, each keeping its own
    settings. The ~0.3 GB state file goes when the test ends."""
    request.addfinalizer(lambda: shutil.rmtree(tmp_path, ignore_errors=True))
    cfg = _cfg()
    batch = _batch(cfg)
    state = _state(cfg)
    make_train_step(state.model, cfg, device="cpu")(state, batch)
    checkpointer = Checkpointer(str(tmp_path))
    if written_by == "host_adam":
        checkpointer.save(0, state)
    else:
        saved = copy.deepcopy(state.optimizer.state_dict())
        for group in saved["param_groups"]:
            group.update(lr=torch.full((), group["lr"]), capturable=True, foreach=True)
        torch.save({"model": state.model.state_dict(), "optimizer": saved,
                    "step": state.step, "seed": state.seed, "epoch": 0},
                   os.path.join(tmp_path, "state_0000.pt"))

    live_host = _state(cfg)
    live_card = _capturable_twin(_state(cfg))
    rate = live_card.optimizer.param_groups[0]["lr"]
    for live in (live_host, live_card):
        checkpointer.restore(live)
        for (name, x), y in zip(live.model.state_dict().items(),
                                state.model.state_dict().values()):
            assert torch.equal(x, y), name
        assert (live.step, live.seed) == (state.step, state.seed)
        moments = live.optimizer.state_dict()["state"]
        for i, entry in state.optimizer.state_dict()["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(moments[i][key], entry[key]), (i, key)
            assert float(moments[i]["step"]) == float(entry["step"])
            assert moments[i]["step"].dtype == torch.float32
    assert live_host.optimizer.param_groups[0]["lr"] == cfg.learning_rate
    assert not live_host.optimizer.param_groups[0]["capturable"]
    assert live_card.optimizer.param_groups[0]["lr"] is rate
    assert live_card.optimizer.param_groups[0]["capturable"]

    # the restored host Adam steps on as the original state does
    for s in (state, live_host):
        make_train_step(s.model, cfg, device="cpu")(s, batch)
    _assert_states_equal(live_host, state)
