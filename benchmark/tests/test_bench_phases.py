"""`benchmark/phases.py` and the readers of the program's phases on
hand-made traces: the busy and wall ms of each phase between the marks,
an NCCL kernel that spans a boundary split between two phases and left
out of the networks' time, None without marks or with a torn mark count,
the host ms of the call ranges less their CUDA calls and the profiler's
records, and the marks' names outside every kernel class."""

import pytest

from benchmark import phases, trace
from benchmark.manifest import reader
from benchmark.trace import Trace

ORDER = ("decode", "networks_fwd", "loss_fwd", "loss_bwd", "networks_bwd",
         "grad_sync", "optimizer", "metrics", "end")
# one call, in us from its start: each mark 1 us long at these starts
STARTS = dict(decode=10, networks_fwd=20, loss_fwd=40, loss_bwd=70, networks_bwd=100,
              grad_sync=120, optimizer=150, metrics=160, end=170)
CALL_US = 200


def _call(offset, grad_sync=False, nccl=None):
    """The device spans of one call starting at `offset`: the marks and,
    in each phase, one kernel from 2 us after its mark to 1 us before
    the next; `nccl` = (start, end) adds an NCCL kernel there."""
    names = [p for p in ORDER if grad_sync or p != "grad_sync"]
    spans = [(f"phase_mark_{p}", offset + STARTS[p], offset + STARTS[p] + 1) for p in names]
    ends = [STARTS[n] for n in names[1:]] + [CALL_US + 1]
    spans += [(f"kernel_{p}", offset + STARTS[p] + 2, offset + stop - 1)
              for p, stop in zip(names, ends)]
    spans.append(("copy_in", offset + 2, offset + 8))  # staged before the marks
    if nccl:
        spans.append(("ncclDevKernel_AllReduce", offset + nccl[0], offset + nccl[1]))
    return spans


def _trace(calls=2, **kwargs):
    device = [s for c in range(calls) for s in _call(c * CALL_US, **kwargs)]
    host = [("train_step/call", c * CALL_US, c * CALL_US + 50.0 + c) for c in range(calls)]
    return Trace(calls, calls * CALL_US / 1e6, device, host)


def test_phase_times_from_hand_placed_marks():
    got = phases.split(_trace())
    # a phase's kernel runs from its mark's start + 2 to the next mark - 1
    assert got.busy_ms["loss_fwd"] == pytest.approx((70 - 1 - 42) / 1e3)
    assert got.busy_ms["networks_bwd"] == pytest.approx((150 - 1 - 102) / 1e3)
    assert got.wall_ms["loss_fwd"] == pytest.approx((70 - 41) / 1e3)
    assert "grad_sync" not in got.busy_ms
    assert got.marks_ms == pytest.approx(8 / 1e3)
    # the copy-in of the first call lies before the first mark, that of the
    # second after the first call's end mark: both belong to `end`, with the
    # end kernels of both calls
    assert got.busy_ms["end"] == pytest.approx((2 * (200 - 172) + 2 * 6) / 1e3 / 2)
    # every device operation lies in a phase: phases and marks cover busy
    busy = sum(got.busy_ms.values()) + got.marks_ms
    assert busy == pytest.approx(_trace().busy_s * 1e3 / 2)


def test_readers_of_the_phases():
    run = {"trace": _trace(grad_sync=True)}
    assert reader("loss_stack_ms.train")(run) == pytest.approx((70 - 1 - 42 + 100 - 1 - 72) / 1e3)
    assert reader("networks_ms.train")(run) == pytest.approx((40 - 1 - 22 + 120 - 1 - 102) / 1e3)
    assert reader("optimizer_ms.train")(run) == pytest.approx((160 - 1 - 152) / 1e3)
    assert reader("grad_sync_ms.train")(run) == pytest.approx((150 - 121) / 1e3)
    assert reader("host_ms.train")(run) == pytest.approx(0.0505)
    assert reader("grad_sync_ms.train")({"trace": _trace()}) is None


def test_an_nccl_kernel_across_a_boundary_is_split():
    """On its own stream an all-reduce overlaps the optimizer's mark: its
    part before the mark is grad_sync's, the rest the optimizer's."""
    got = phases.split(_trace(grad_sync=True, nccl=(125, 156)))
    plain = phases.split(_trace(grad_sync=True))
    # grad_sync's own kernel covers 122-149: the NCCL kernel adds 149-150
    assert got.busy_ms["grad_sync"] - plain.busy_ms["grad_sync"] == pytest.approx(1 / 1e3)
    # after the mark (151) it runs to 156, over the optimizer's kernel from 152
    assert got.busy_ms["optimizer"] - plain.busy_ms["optimizer"] == pytest.approx(1 / 1e3)


def test_the_networks_time_leaves_nccl_out():
    """Synced batch norm's sums in networks_bwd: NCCL kernels that wait
    for the other ranks count in the phase's busy time, not in the
    networks' metric."""
    run = {"trace": _trace(grad_sync=True, nccl=(101, 130))}
    plain = {"trace": _trace(grad_sync=True)}
    got = phases.split(run["trace"])
    # networks_bwd's kernel covers 102-119: the NCCL kernel adds 101-102
    # and 119-120 to its busy time, none to its compute time
    assert got.busy_ms["networks_bwd"] - got.compute_ms["networks_bwd"] == pytest.approx(2 / 1e3)
    assert reader("networks_ms.train")(run) == pytest.approx(reader("networks_ms.train")(plain))
    assert reader("loss_stack_ms.train")(run) == pytest.approx(reader("loss_stack_ms.train")(plain))


def test_host_ms_leaves_out_the_cuda_calls_inside_each_call():
    """A call's range less the CUDA runtime and driver calls and the
    profiler's records nested in it (a graph launch blocked on a full
    queue, inside it "Command Buffer Full", a copy's launch, a buffer
    flush); the host's own ops and a CUDA call outside every range stay
    out of the subtraction."""
    run = {"trace": _trace()}
    run["trace"].host += [
        ("cudaGraphLaunch", 10.0, 40.0), ("Command Buffer Full", 12.0, 39.0),
        ("cuLaunchKernel", 45.0, 47.0), ("aten::copy_", 3.0, 9.0),
        ("cudaMemcpyAsync", 4.0, 5.0), ("cudaStreamSynchronize", 60.0, 180.0),
        ("Buffer Flush", CALL_US + 20.0, CALL_US + 24.0),
        ("cudaGraphLaunch", CALL_US + 48.0, CALL_US + 70.0)]
    # call 0: 50 us less 30 + 2 + 1; call 1: 51 us less 4 + its launch's 3 us inside
    assert reader("host_ms.train")(run) == pytest.approx(((50 - 33) + (51 - 7)) / 2 / 1e3)


def test_no_phases_without_marks_or_with_a_torn_count():
    bare = _trace()
    bare.device = [s for s in bare.device if not s[0].startswith("phase_mark_")]
    assert phases.split(bare) is None
    torn = _trace()
    torn.device = [s for s in torn.device
                   if not (s[0] == "phase_mark_optimizer" and s[1] > CALL_US)]
    assert phases.split(torn) is None
    names = ("loss_stack_ms.train", "networks_ms.train", "optimizer_ms.train",
             "grad_sync_ms.train")
    for run in ({"trace": bare}, {"trace": torn}, {}):
        assert all(reader(n)(run) is None for n in names)
    assert reader("host_ms.train")({"trace": Trace(1, 1.0, bare.device, [])}) is None


@pytest.mark.parametrize("name", ORDER)
def test_a_mark_falls_in_no_kernel_class(name):
    assert trace.kernel_class(f"phase_mark_{name}") == "elementwise"
