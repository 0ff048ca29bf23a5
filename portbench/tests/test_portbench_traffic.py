"""The traffic generator alone: every parameter kind a mix file may use
draws the same instances from the same seed, inside its range, with the
numeric kinds stratified over the pool; and each stream holds every
template once."""

from __future__ import annotations

import itertools

import pytest

from portbench.core import traffic
from portbench.core.tables import days

SEED = 3_000_000_037
POOL = 4

KINDS = {
    "date": ({"kind": "date", "base": "1995-03-01", "lo": 0, "hi": 30}, ["X"]),
    "month": ({"kind": "month", "from": "1993-01", "to": "1997-10", "step": 3, "plus": 3,
               "names": ["LO", "HI"]}, ["LO", "HI"]),
    "int": ({"kind": "int", "lo": 1, "hi": 50, "plus": {"Y": 10}}, ["X", "Y"]),
    "float": ({"kind": "float", "lo": 0.02, "hi": 0.09, "digits": 2, "plus": {"Y": 0.02}}, ["X", "Y"]),
    "choice": ({"kind": "choice", "values": ["AIR", "MAIL", "SHIP", "RAIL", "TRUCK"]}, ["X"]),
    "sample": ({"kind": "sample", "k": 3, "values": [11, 12, 13, 14, 15, 16, 17]}, ["X"]),
    "per_scale": ({"kind": "per_scale", "value": 0.0001}, ["X"]),
}


def mix_of(spec: dict, names: list) -> dict:
    sql = "SELECT " + ", ".join(f"{{{n}}}" for n in names)
    return {"pool": POOL, "templates": {"t": {"sql": sql, "params": {"X": spec}, "ordered": True}}}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kind_draws_from_the_seed(kind):
    spec, names = KINDS[kind]
    cfg = {"scale_factor": 10}
    a = traffic.instances(mix_of(spec, names), cfg, SEED)["t"]
    b = traffic.instances(mix_of(spec, names), cfg, SEED)["t"]
    c = traffic.instances(mix_of(spec, names), cfg, SEED + 1)["t"]
    assert a == b and len(a) == POOL
    assert [i.params for i in a] != [i.params for i in c] or kind == "per_scale"
    for inst in a:
        p = inst.params
        assert set(p) == set(names)
        if kind == "date":
            assert days("1995-03-01") <= p["X"] <= days("1995-03-31")
        elif kind == "month":
            assert p["LO"] < p["HI"] and days("1993-01-01") <= p["LO"] <= days("1997-10-01")
        elif kind in ("int", "float"):
            assert spec["lo"] <= p["X"] <= spec["hi"]
            assert p["Y"] == pytest.approx(p["X"] + spec["plus"]["Y"])
        elif kind == "choice":
            assert p["X"] in spec["values"]
        elif kind == "sample":
            assert len(set(p["X"])) == 3 and set(p["X"]) <= set(spec["values"])
        else:
            assert p["X"] == pytest.approx(0.00001)
    if kind in ("int", "float"):  # stratified: one instance in each quarter of the range
        width = spec["hi"] - spec["lo"]
        quarters = sorted(min(int((i.params["X"] - spec["lo"]) / width * POOL), POOL - 1) for i in a)
        assert quarters == list(range(POOL))
    if kind == "choice":  # distinct across the pool where there are enough values
        assert len({i.params["X"] for i in a}) == POOL


def test_streams_hold_every_template_once():
    mix = {"pool": POOL, "templates": {n: {} for n in ("a", "b", "c")}}
    streams = list(itertools.islice(traffic.streams(mix, SEED), 8))
    assert all(sorted(t for t, _ in s) == ["a", "b", "c"] for s in streams)
    for name in ("a", "b", "c"):  # each template walks its whole pool before it repeats
        walk = [i for s in streams for t, i in s if t == name]
        assert sorted(walk[:POOL]) == list(range(POOL)) and sorted(walk[POOL:]) == list(range(POOL))
    assert streams == list(itertools.islice(traffic.streams(mix, SEED), 8))
