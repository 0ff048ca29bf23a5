"""Host-stage scalar functions and the built-in geospatial UDFs.

Some scalar functions produce values a TPU cannot represent (variable-
length text, struct records). The engine's split: the jit pipeline
computes the function's *argument* columns on device (scan/filter/project
all fused by XLA); the function itself runs once on the materialized
host columns at result time — the same boundary where string decoding
and Rust-Debug formatting already live (exec/result.py).

A host function is registered by wrapping its implementation in
`HostFunction`; the plan compiler splits the top-level projection around
it (exec/compiler.py split_host_projection). The implementation receives
decoded numpy arrays (one per argument, full result length) and returns
one numpy array of per-row values.

The geospatial functions realize the reference console's commented-out
registration (reference: src/bin/console/main.rs:25-27,123-125) and the
docker smoketest that exercised them (reference: test/data/smoketest.sql,
scripts/smoketest.sh:76-96). ST_Point returns a Struct value — the
reference's ScalarValue::Struct variant, which it declared but never
executed (reference: logicalplan.rs:110,128 `unimplemented!()`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class HostFunction:
    """Marker wrapper: this scalar function runs on host at materialization
    time (arguments are computed on device and shipped back once)."""

    def __init__(self, fn: Callable[..., np.ndarray]):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class CastRenderHost(HostFunction):
    """Host-stage renderer for `CAST(<non-string> AS VARCHAR)`.

    Strings on device exist only as dictionary codes, and a numeric
    column's distinct values are unknown at compile time — so the cast's
    *argument* computes on device like any projection column and the
    decimal rendering happens once on the materialized host result
    (the same boundary as every other HostFunction). Rendering uses
    Rust `{}` Display semantics (shortest round-trip floats, true/false
    booleans, ISO dates) to match the engine's display formatter.

    Beyond the reference: its casts were Int16/Int32-only
    (expression.rs:272-280).
    """

    def __init__(self, src_dtype):
        self.src_dtype = src_dtype
        super().__init__(self._render)

    def _render(self, data: np.ndarray) -> np.ndarray:
        from datafusion_tpu_torch.types import DataType

        dt = self.src_dtype
        if dt is DataType.Float64:
            from datafusion_tpu_torch.utils.fmt import rust_f64

            return np.array([rust_f64(float(v)) for v in data], dtype=object)
        if dt is DataType.Float32:
            from datafusion_tpu_torch.utils.fmt import rust_f32

            return np.array([rust_f32(float(v)) for v in data], dtype=object)
        if dt is DataType.Boolean:
            return np.array(
                ["true" if v else "false" for v in data], dtype=object
            )
        if dt is DataType.Date32:
            from datafusion_tpu_torch.utils.dates import format_days

            return np.array([format_days(int(v)) for v in data], dtype=object)
        if dt is DataType.Timestamp:
            from datafusion_tpu_torch.utils.dates import format_seconds

            return np.array([format_seconds(int(v)) for v in data], dtype=object)
        return np.array([str(int(v)) for v in data], dtype=object)


class AggregateUDF:
    """A user aggregate as a map/combine/finalize monoid (the reference's
    FunctionType::Aggregate registry existed but get_function_meta was
    unimplemented!, context.rs:255-257; this makes UDAFs executable,
    grouped AND distributed, by desugaring onto the built-in reductions):

        result = finalize(combine_over_group(map(*args)), count)

    * map: elementwise torch fn over the argument column(s) → one tensor
      (None = identity on the first argument)
    * combine: "sum" | "min" | "max" — the per-group reduction
    * finalize: torch fn (combined, count) → result (None = combined)

    Example — geometric mean:
        AggregateUDF(map=torch.log, combine="sum",
                     finalize=lambda s, n: torch.exp(s / n))

    The desugared plan is ordinary SUM/MIN/MAX + COUNT, so every route
    (K2 dense or sorted, K3 + K4, and on a mesh the dense merge, the K6
    fold or the partial + all_gather merge) runs it unchanged.
    """

    COMBINES = ("sum", "min", "max")

    def __init__(
        self,
        map: Callable | None = None,
        combine: str = "sum",
        finalize: Callable | None = None,
    ):
        if combine not in self.COMBINES:
            raise ValueError(
                f"AggregateUDF combine must be one of {self.COMBINES}, "
                f"got {combine!r}"
            )
        self.map_fn = map
        self.combine = combine
        self.finalize_fn = finalize


# ---------------------------------------------------------------------------
# Geospatial built-ins (reference: the POC-era ST_Point / ST_AsText UDFs)
# ---------------------------------------------------------------------------


def st_point(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """ST_Point(x, y) → Struct{x, y} as an object array of float tuples."""
    out = np.empty(len(x), dtype=object)
    for i in range(len(x)):
        out[i] = (float(x[i]), float(y[i]))
    return out


def st_astext(points: np.ndarray) -> np.ndarray:
    """ST_AsText(point) → WKT text, matching the reference smoketest's
    `POINT (x y)` rendering with Rust Display float formatting
    (reference: test/data/smoketest-expected.txt)."""
    from datafusion_tpu_torch.utils.fmt import rust_f64

    out = np.empty(len(points), dtype=object)
    for i, p in enumerate(points):
        out[i] = f"POINT ({rust_f64(p[0])} {rust_f64(p[1])})"
    return out


def register_geospatial(ctx) -> None:
    """Register ST_Point / ST_AsText on an ExecutionContext (the console
    does this by default, realizing reference main.rs:123-125)."""
    from datafusion_tpu_torch.plan.planner import FunctionMeta, FunctionType
    from datafusion_tpu_torch.schema import Field
    from datafusion_tpu_torch.types import DataType as D

    ctx.register_function(
        FunctionMeta(
            "ST_Point",
            (Field("x", D.Float64, False), Field("y", D.Float64, False)),
            D.Struct,
            FunctionType.Scalar,
        ),
        HostFunction(st_point),
    )
    ctx.register_function(
        FunctionMeta(
            "ST_AsText",
            (Field("geom", D.Struct, False),),
            D.Utf8,
            FunctionType.Scalar,
        ),
        HostFunction(st_astext),
    )
