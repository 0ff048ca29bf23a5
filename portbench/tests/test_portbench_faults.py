"""The run, with the port broken underneath, comes out not correct: once
for each fault a cell can have. The harness's look for a card is skipped
(the CPU path), the rest of the run is the driver's."""

from __future__ import annotations

import json

import pytest

from conftest import REPO, make_checkout, run_checkout

SEED = 2_147_483_677

# an answer altered where it is produced: the last column's first value
ALTERED = """
import numpy as np
from datafusion_tpu_torch.exec import context as _c
_run = _c.ExecutionContext.execute
def _altered(self, plan):
    res = _run(self, plan)
    if res.cols and res.num_rows:
        d, v = res.cols[-1]
        d = np.array(d, copy=True)
        d[0] = d[0] * (1 + 1e-6) if d.dtype.kind == "f" else d[0] + 1
        res.cols[-1] = (d, v)
    return res
_c.ExecutionContext.execute = _altered
"""

# half of the rows left out: every table (every shard of a mesh's) registers its first half only
HALF = """
from datafusion_tpu_torch.exec import context as _c
from datafusion_tpu_torch.columnar.table import Column, Table
from datafusion_tpu_torch.parallel.mesh import ShardTable
_reg = _c.ExecutionContext.register_table
def _cut(table):
    n = table.num_rows // 2
    cols = tuple(Column(c.dtype, c.data[:n], None if c.validity is None else c.validity[:n], c.dictionary)
                 for c in table.columns)
    return Table(table.schema, cols, n)
def _half(self, name, table):
    if isinstance(table, ShardTable):
        shards = tuple(_cut(t) for t in table.shards)
        return _reg(self, name, ShardTable(table.schema, shards, sum(t.num_rows for t in shards)))
    return _reg(self, name, _cut(table))
_c.ExecutionContext.register_table = _half
"""

# the exchange between cards left out: each shard keeps only what it sent to itself
NO_EXCHANGE = """
import torch
from datafusion_tpu_torch.parallel import shuffle as _s
_ex, _fold = _s.ragged_exchange, _s.ragged_exchange_fold
def _own(sizes):
    return sizes * torch.eye(sizes.shape[0], sizes.shape[1], dtype=sizes.dtype, device=sizes.device)
_s.ragged_exchange = lambda senders, sizes, **kw: _ex(senders, _own(sizes), **kw)
_s.ragged_exchange_fold = lambda g, v, m, sizes, **kw: _fold(g, v, m, _own(sizes), **kw)
"""

CELLS = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]
FAULTS = [(c["name"], "altered", ALTERED) for c in CELLS] + [(c["name"], "half", HALF) for c in CELLS] + [
    (c["name"], "no_exchange", NO_EXCHANGE) for c in CELLS if c["chips"] > 1]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell,fault,patch", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(checkout, cell, fault, patch):
    rc, out, err = run_checkout(checkout, ["--workload", cell, "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                                patch=patch)
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]
