"""The one traffic generator: it reads a mix's data file
(`mixes/<traffic>.json`) and draws, from the seed, each template's pool of
instances and the order of the streams.

A mix file holds `templates` (name -> `sql` with `{NAME}` placeholders,
`params`, and `ordered`: whether the result's row order is defined),
`pool` (instances per template), `keep` (how many results of a window
the comparison reads, a sample drawn from the seed) and `reference` (the
module under `reference/` that computes each template plainly).

Parameter kinds (each draws one value per instance; the numeric kinds are
stratified, instance i in its own quarter of the range, so every seed
gets the same spread of work in another order):
  date     `base` + a whole number of days in [`lo`, `hi`]
  month    the first day of a month from `from` to `to` (YYYY-MM) by
           `step` months, and that day `plus` months later: two `names`
  int      a whole number in [`lo`, `hi`]; `plus` adds named offsets
  float    a number in [`lo`, `hi`) to `digits` decimals; `plus` likewise
  choice   one of `values` (a value may be an object of several names),
           distinct across the pool where there are enough values
  sample   `k` distinct `values` (or one per name of `names`)
  per_scale  `value` over the configuration's `scale_factor`
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from portbench.core.tables import days, iso


@dataclass(frozen=True)
class Instance:
    template: str
    index: int
    sql: str
    values: tuple  # ((name, python value), ...): dates as days since 1970-01-01

    @property
    def params(self) -> dict:
        return dict(self.values)


def load_mix(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _rng(seed: int, *salt: str) -> random.Random:
    return random.Random("/".join((str(seed),) + salt))


def _strata(rng: random.Random, pool: int) -> list[float]:
    """One point in each of `pool` equal parts of [0, 1), in a random
    order over the instances."""
    order = list(range(pool))
    rng.shuffle(order)
    return [(order[i] + rng.random()) / pool for i in range(pool)]


def _add_months(ym: tuple[int, int], months: int) -> tuple[int, int]:
    m = ym[0] * 12 + ym[1] - 1 + months
    return m // 12, m % 12 + 1


def _draw(name: str, spec: dict, pool: int, rng: random.Random, cfg: dict) -> list[dict]:
    """`pool` assignments {param name: (python value, SQL text)}."""
    kind = spec["kind"]
    out: list[dict] = [{} for _ in range(pool)]
    if kind in ("date", "int", "float", "month"):
        u = _strata(rng, pool)
        for i in range(pool):
            if kind == "date":
                off = spec["lo"] + int(u[i] * (spec["hi"] - spec["lo"] + 1))
                d = days(spec["base"]) + off
                out[i][name] = (d, iso(d))
            elif kind == "month":
                y0, m0 = (int(x) for x in spec["from"].split("-"))
                y1, m1 = (int(x) for x in spec["to"].split("-"))
                n = ((y1 * 12 + m1) - (y0 * 12 + m0)) // spec["step"] + 1
                first = _add_months((y0, m0), spec["step"] * int(u[i] * n))
                last = _add_months(first, spec["plus"])
                for nm, (y, m) in zip(spec["names"], (first, last)):
                    d = days(f"{y:04d}-{m:02d}-01")
                    out[i][nm] = (d, iso(d))
            elif kind == "int":
                v = spec["lo"] + int(u[i] * (spec["hi"] - spec["lo"] + 1))
                out[i][name] = (v, str(v))
                for nm, off in spec.get("plus", {}).items():
                    out[i][nm] = (v + off, str(v + off))
            else:
                digits = spec["digits"]
                text = f"{spec['lo'] + u[i] * (spec['hi'] - spec['lo']):.{digits}f}"
                out[i][name] = (float(text), text)
                for nm, off in spec.get("plus", {}).items():
                    t2 = f"{float(text) + off:.{digits}f}"
                    out[i][nm] = (float(t2), t2)
    elif kind == "choice":
        values = spec["values"]
        picks = rng.sample(values, pool) if pool <= len(values) else [rng.choice(values) for _ in range(pool)]
        for i, v in enumerate(picks):
            for nm, x in (v.items() if isinstance(v, dict) else ((name, v),)):
                out[i][nm] = (float(x) if isinstance(v, dict) else x, str(x))
    elif kind == "sample":
        names = spec.get("names")
        k = len(names) if names else spec["k"]
        for i in range(pool):
            vals = rng.sample(spec["values"], k)
            if names:
                for nm, v in zip(names, vals):
                    out[i][nm] = (v, str(v))
            else:
                out[i][name] = (tuple(vals), ", ".join(f"'{v}'" if isinstance(v, str) else str(v) for v in vals))
    elif kind == "per_scale":
        text = f"{spec['value'] / cfg['scale_factor']:.15f}".rstrip("0")
        for i in range(pool):
            out[i][name] = (float(text), text)
    else:
        raise ValueError(f"unknown parameter kind {kind!r} of {name}")
    return out


def instances(mix: dict, cfg: dict, seed: int) -> dict[str, list[Instance]]:
    """Each template's pool of instances, drawn from the seed."""
    pool = mix["pool"]
    out = {}
    for tname, t in mix["templates"].items():
        assign: list[dict] = [{} for _ in range(pool)]
        for pname, spec in sorted(t["params"].items()):
            for i, a in enumerate(_draw(pname, spec, pool, _rng(seed, tname, pname), cfg)):
                assign[i].update(a)
        out[tname] = [
            Instance(tname, i, t["sql"].format(**{k: text for k, (_, text) in a.items()}),
                     tuple(sorted((k, v) for k, (v, _) in a.items())))
            for i, a in enumerate(assign)
        ]
    return out


def streams(mix: dict, seed: int) -> Iterator[list[tuple[str, int]]]:
    """Endless streams: each holds every template once, in an order drawn
    from the seed; each template walks its pool in a drawn order, so the
    instances are used evenly."""
    rng = _rng(seed, "streams")
    names = list(mix["templates"])
    pool = mix["pool"]
    walks = {n: [] for n in names}
    while True:
        order = names[:]
        rng.shuffle(order)
        stream = []
        for n in order:
            if not walks[n]:
                walks[n] = list(range(pool))
                rng.shuffle(walks[n])
            stream.append((n, walks[n].pop()))
        yield stream
