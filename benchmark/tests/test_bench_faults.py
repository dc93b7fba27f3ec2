"""A whole run on the CPU, the look for a card skipped, at a size a test
holds (64x96, batch 4, float32 so that a sound run reads far under every
limit): a sound run is correct, and each fault a cell can have, planted
under the timed path, makes `correct` false; so do faults that break only
the calls after the first, which a card replays from its CUDA graph. The
control (the reference in the precision below the configuration's) fails
the limits too, at the test's size here and at the cell's on a card."""

import dataclasses
import time

import pytest
import torch

from benchmark import calibrate, check
from benchmark.manifest import cell as load_cell
from benchmark.run import run_cell

SECONDS = 0.5


def _small(name, **config):
    c = load_cell(name)
    traffic = dict(c.traffic, ring=3, trace_calls=2)
    return dataclasses.replace(
        c, config=dict(c.config, **dict(dict(height=64, width=96, batch=4), **config)),
        traffic=traffic)


def _run(c, fault=None):
    result, report = run_cell(c, 2**31 + 5, SECONDS, False, torch.device("cpu"),
                              time.time(), fault=fault)
    return result


def _unchanged(setup):
    setup.state.apply_gradients = lambda lr=None: None


def _half_batch(setup):
    step = setup.step

    def half(state, batch, noise):
        n = batch["frames"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()},
                    {k: v[:n] for k, v in noise.items()})

    setup.step = half


def _stale_input(setup):
    """The calls after the first take the first call's batch and noise."""
    step, calls = setup.step, []

    def stale(state, batch, noise):
        calls.append((batch, noise))
        return step(state, *calls[0])

    setup.step = stale


def _replays_unchanged(setup):
    """The calls after the first lose their update."""
    step, calls = setup.step, []

    def later(state, batch, noise):
        if calls:
            state.apply_gradients = lambda lr=None: None
        calls.append(1)
        return step(state, batch, noise)

    setup.step = later


def _no_exchange(setup):
    """Each rank keeps its own gradients: the all-reduce left out."""
    from monodepth_tpu_torch.training import step

    step.average_gradients = lambda model, mesh: None


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch, _stale_input,
                                   _replays_unchanged])
def test_a_fault_makes_the_run_incorrect(fault, few_threads):
    name = "r18_mono_640x192.train"
    result = _run(_small(name, precision="f32"), fault)
    assert result["correct"] is (fault is None)
    assert result["attempted"] > 0
    assert set(result["metrics"]) == set(load_cell(name).end_to_end)


@pytest.mark.parametrize("fault", [None, _no_exchange])
def test_a_mesh_run_without_the_exchange_is_incorrect(fault, few_threads):
    """The four-card cell on two gloo ranks of the CPU."""
    c = dataclasses.replace(_small("r18_mono_640x192.train_dp4", precision="f32", batch=2),
                            chips=2)
    result = _run(c, fault)
    assert result["correct"] is (fault is None)
    assert result["device"]["count"] == 2


def test_the_control_fails(few_threads):
    c = _small("r18_mono_640x192.train")
    readings = calibrate.train_seed(c, 7, torch.device("cpu"), True)
    assert check.verdict(readings["control"], c.limits)[0] is False


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["r18_mono_640x192.train", "r50_mono_640x192.train"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_fails_at_the_cells_size(name, seed, card):
    c = load_cell(name)
    readings = calibrate.train_seed(c, seed, card, True)
    assert check.verdict(readings["program"], c.limits)[0] is True
    assert check.verdict(readings["control"], c.limits)[0] is False
