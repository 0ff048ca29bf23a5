"""The port's measurement helpers on the CPU: utils/roofline.py against
the JAX package's cost model (tests/test_roofline_writer.py's
test_roofline_math, with the H100's published HBM rate), its card table,
and utils/benchtime.py's clock choice and return contract."""

import pytest
import torch

from datafusion_tpu.utils import roofline as jax_roofline
from datafusion_tpu_torch.utils import benchtime, roofline


def test_roofline_math():
    cost = roofline.filter_project_cost(1_000_000, 8, 4)
    assert cost.bytes_total == 1_000_000 * 13
    t = roofline.roofline_seconds(cost, bw_gbps=3350.0)
    assert abs(t - cost.bytes_total / 3350e9) < 1e-12
    assert abs(roofline.achieved_fraction(cost, t, bw_gbps=3350.0) - 1.0) < 1e-9


@pytest.mark.parametrize("name,args", [("filter_project_cost", (1_000_000, 8, 4)), ("sort_cost", (4096, 12, 3)),
                                       ("grouped_agg_cost", (1 << 20, 8, 16))])
def test_costs_equal_the_jax_package(name, args):
    got, want = getattr(roofline, name)(*args), getattr(jax_roofline, name)(*args)
    assert (got.name, got.bytes_read, got.bytes_written) == (want.name, want.bytes_read, want.bytes_written)
    assert roofline.roofline_seconds(got, 3350.0) == jax_roofline.roofline_seconds(want, 3350.0)
    assert roofline.achieved_fraction(got, 1e-3, 3350.0) == jax_roofline.achieved_fraction(want, 1e-3, 3350.0)


@pytest.mark.parametrize("card,gbps", [("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
                                       ("NVIDIA H100 NVL", 3900.0)])
def test_chip_hbm_gbps_by_card_name(monkeypatch, card, gbps):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: card)
    assert roofline.chip_hbm_gbps() == gbps


def test_chip_hbm_gbps_raises_off_the_table(monkeypatch):
    with pytest.raises(ValueError, match="roofline is the card's"):
        roofline.chip_hbm_gbps("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA device"):
        roofline.chip_hbm_gbps()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no published HBM bandwidth"):
        roofline.chip_hbm_gbps()


def _no_events(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU pipeline must not be timed with CUDA events")

    monkeypatch.setattr(torch.cuda, "Event", refuse)


def test_time_pipeline_median_on_the_host_clock(monkeypatch):
    _no_events(monkeypatch)
    x = torch.arange(4096, dtype=torch.float64)
    t = benchtime.time_pipeline(lambda e: {"out": [e * 2.0]}, x, depths=(2, 4), trials=3)
    assert isinstance(t, float) and t > 0


def test_time_pipeline_with_spread(monkeypatch):
    _no_events(monkeypatch)
    med, spread = benchtime.time_pipeline(lambda e: e.sum(), torch.ones(1000), depths=(4,), repeats=5,
                                          with_spread=True)
    assert med > 0 and spread >= 0


def test_output_device_finds_nested_tensors():
    assert benchtime._output_device(("a", [None, {"k": torch.zeros(1)}])) == torch.device("cpu")
    assert benchtime._output_device([1, "x"]) is None
