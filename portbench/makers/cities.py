"""The cities table on the device: the reference project's uk_cities
filter and GROUP BY aggregates at scale. `k` has 65,536 values, `d`
1,000, `g` 1-10,000 (TPC-H `l_suppkey` at SF1); `lat` and `lng` are
float64 within the UK's bounds. The row count is the configuration's;
each row block is drawn on its own device by a generator there."""

from __future__ import annotations

import torch

from portbench.core.tables import Col, Tab, Tables, block_rows


def make(cfg: dict, seed: int, devices: list) -> Tables:
    cols = {name: [] for name in ("k", "d", "lat", "lng", "g")}
    for i, (device, n) in enumerate(zip(devices, block_rows(cfg["rows"]["cities"], len(devices)))):
        g = torch.Generator(device=device)
        g.manual_seed(seed + (i << 40))  # block 0 draws from the seed itself

        def ints(lo: int, hi: int) -> torch.Tensor:  # [lo, hi)
            return torch.randint(lo, hi, (n,), generator=g, device=device, dtype=torch.int32)

        def uniform(lo: float, width: float) -> torch.Tensor:
            return torch.rand(n, generator=g, device=device, dtype=torch.float64) * width + lo

        cols["k"].append(ints(0, 65536))
        cols["d"].append(ints(0, 1000))
        cols["lat"].append(uniform(48.0, 10.0))
        cols["lng"].append(uniform(-9.0, 12.0))
        cols["g"].append(ints(1, 10001))
    kinds = {"k": "int32", "d": "int32", "lat": "float64", "lng": "float64", "g": "int32"}
    return Tables({"cities": Tab("cities", [Col(name, kinds[name], tuple(b)) for name, b in cols.items()])})
