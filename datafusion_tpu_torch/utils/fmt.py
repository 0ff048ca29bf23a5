"""Rust-`{:?}`-compatible value formatting.

The reference's integration goldens render results with Rust's Debug
formatting (reference: tests/sql.rs:107-135): floats as shortest
round-trip, strings quoted-and-escaped. Python's `repr` matches Rust for
floats except in exponent style, which we normalize here.
"""

from __future__ import annotations

import math


def rust_f64(v: float) -> str:
    """Format an f64 like Rust's `{:?}` / `{}` (shortest round-trip)."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    r = repr(float(v))
    if "e" in r or "E" in r:
        # python: '1e+21' / '1.5e-07'  →  rust: '1e21' / '1.5e-7'
        mant, _, exp = r.partition("e")
        exp_i = int(exp)
        return f"{mant}e{exp_i}"
    return r


def rust_f32(v: float) -> str:
    """Format an f32 like Rust's `{:?}`: shortest decimal that round-trips
    through f32."""
    import numpy as np

    f = np.float32(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "inf" if f > 0 else "-inf"
    # shortest digits preserving the f32 value
    for prec in range(1, 10):
        s = f"{float(f):.{prec}g}"
        if np.float32(float(s)) == f:
            break
    else:
        s = repr(float(f))
    if "e" in s:
        mant, _, exp = s.partition("e")
        s = f"{mant}e{int(exp)}"
    elif "." not in s and "inf" not in s:
        s += ".0"
    return s


def rust_str_debug(s: str) -> str:
    """Format a string like Rust's `{:?}`: double-quoted with escapes."""
    out = ['"']
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def rust_debug_scalar(sv) -> str:
    """Debug-format a ScalarValue like Rust derive(Debug)
    (reference: logicalplan.rs:95 `#[derive(..., Debug, ...)]`)."""
    from datafusion_tpu_torch.types import DataType

    dt, v = sv.dtype, sv.value
    if v is None:
        return "Null"  # reference: ScalarValue::Null derive(Debug)
    if dt is DataType.Utf8:
        return f"Utf8({rust_str_debug(v)})"
    if dt is DataType.Float64:
        return f"Float64({rust_f64(v)})"
    if dt is DataType.Float32:
        return f"Float32({rust_f32(v)})"
    if dt is DataType.Boolean:
        return f"Boolean({'true' if v else 'false'})"
    return f"{dt.value}({int(v)})"


def format_cell(dtype, value) -> str:
    """Render one result cell the way the reference's result_str does
    (reference: tests/sql.rs:113-131): Debug format per dtype, Utf8 quoted."""
    from datafusion_tpu_torch.types import DataType

    if dtype is DataType.Utf8:
        return rust_str_debug(value)
    if dtype is DataType.Date32:
        import datetime as _dtm

        if isinstance(value, _dtm.date):
            return value.isoformat()
        from datafusion_tpu_torch.utils.dates import format_days

        return format_days(int(value))
    if dtype is DataType.Timestamp:
        import datetime as _dtm

        if isinstance(value, _dtm.datetime):
            return value.isoformat(sep=" ")
        from datafusion_tpu_torch.utils.dates import format_seconds

        return format_seconds(int(value))
    if dtype is DataType.Float64:
        return rust_f64(float(value))
    if dtype is DataType.Float32:
        return rust_f32(float(value))
    if dtype is DataType.Boolean:
        return "true" if value else "false"
    if dtype is DataType.Struct:
        # Rust derive(Debug) shape for ScalarValue::Struct(Vec<ScalarValue>)
        # (the reference declared the variant but could not print it —
        # logicalplan.rs:110, tests/sql.rs has no Struct arm)
        parts = []
        for v in value:
            if isinstance(v, float):
                parts.append(f"Float64({rust_f64(v)})")
            elif isinstance(v, bool):
                parts.append(f"Boolean({'true' if v else 'false'})")
            elif isinstance(v, int):
                parts.append(f"Int64({v})")
            else:
                parts.append(f"Utf8({rust_str_debug(str(v))})")
        return "Struct([" + ", ".join(parts) + "])"
    return str(int(value))


def display_cell(dtype, value) -> str:
    """Rust `{}` Display rendering: like Debug but strings unquoted —
    the format of the reference's POC-era console output
    (reference: test/data/smoketest-expected.txt)."""
    from datafusion_tpu_torch.types import DataType

    if dtype is DataType.Utf8:
        return str(value)
    return format_cell(dtype, value)
