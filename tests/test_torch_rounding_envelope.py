"""`tools/rounding_envelope.py` on the CPU at 32x64, batch 2: each change
it makes moves rounding only. In f64 every change's losses and first-step
gradients stay within 1e-10 of the unchanged run's and no per-pixel choice
flips; in f32 the repeated run is the same bit for bit, and a one-ulp
change moves something (so the tool measures rounding, not nothing)."""

import pytest

from monodepth_tpu_torch.tools.rounding_envelope import envelope
from torch_parity import one_thread  # noqa: F401 (a fixture)

CONFIG = ["--device", "cpu", "--height", "32", "--width", "64", "--batch", "2",
          "--use_pallas", "false"]
CHANGES = ["repeat", "jitter +1 ulp", "jitter -1 ulp", "jitter +2 ulp",
           "jitter +1 ulp, item 0", "jitter +1 ulp, item 1", "K, inv_K +1 ulp"]


@pytest.fixture(scope="module", params=["f64", "f32"])
def result(request, one_thread):
    """The tool's runs at one intra-op thread: with torch's default, beside
    five other test workers, the two took 266-438 s in a full run."""
    return request.param, envelope(CONFIG + (["--f64"] if request.param == "f64" else []))


def test_changes_are_rounding_only(result):
    precision, out = result
    assert list(out["changes"]) == CHANGES  # no cuDNN change on the CPU
    assert len(out["losses"]) == len(out["envelope"]) == 2
    repeat = out["changes"]["repeat"]
    assert repeat["loss_rel"] == [0.0, 0.0]
    assert set(repeat["grad_rel_l2"].values()) == {0.0}
    if precision == "f64":
        for name, change in out["changes"].items():
            assert max(change["loss_rel"]) <= 1e-10, name
            assert max(change["grad_rel_l2"].values()) <= 1e-10, name
            assert not any(any(v.values()) for k, v in change["choice_flips"].items()
                           if k != "pixels"), name
    else:
        assert max(out["envelope"]) > 0.0
