"""Every cell of BENCHMARK.json reads its traced window through
`core/hostspans.py`. Its `install()` runs when one of the three readers
below is imported, and only the readers a cell lists are imported; a cell
without one would read the port's `dft.*` device annotations as kernels
and as busy time (`kernel_ms`, `device_idle_share`, `roofline_share`)."""

import json

import pytest
from conftest import REPO

HOST_READERS = ("host_syncs", "sync_idle_ms", "wrapper_host_ms")

with open(REPO / "BENCHMARK.json") as f:
    SPEC = json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_lists_a_host_span_reader(cell):
    listed = [m["name"] for m in SPEC["per_layer"]
              if m["name"] in HOST_READERS and cell in m.get("workloads", [cell])]
    assert listed, f"{cell} lists none of {HOST_READERS}: its trace would count the program spans as kernels"
