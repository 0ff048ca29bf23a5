"""Date32 / Timestamp arithmetic: days since the Unix epoch (1970-01-01)
as int32 and seconds since the epoch as int64 <-> civil calendar.

The host half (numpy / Python) parses ingest and literals and renders
results. The device half, on torch tensors, is EXTRACT, DATE_TRUNC and
calendar-month arithmetic: Howard Hinnant's public-domain era-based
algorithms, branch-free integer arithmetic. It mirrors the JAX
package's functions bit for bit: int32 arithmetic wraps (torch's does,
as XLA's), `//` and `%` floor, and the day fields come back as int32.
It is the projection path's code and the plain version of K1's date
opcodes (ops/pallas/fused_stage.py; csrc/fused_stage.cu repeats it).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch


def days_from_civil(y: int, m: int, d: int) -> int:
    """Civil date → days since 1970-01-01 (host scalar)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def parse_iso_date(s: str) -> int:
    """'YYYY-MM-DD' → days since epoch; raises ValueError on bad input."""
    d = datetime.date.fromisoformat(s.strip())
    return days_from_civil(d.year, d.month, d.day)


def date_of_days(days: int) -> datetime.date:
    return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(days))


def format_days(days: int) -> str:
    return date_of_days(days).isoformat()


def to_days_array(values) -> np.ndarray:
    """Host conversion of a python/numpy date-ish column to int32 days:
    accepts datetime.date / datetime64 arrays / ISO strings / ints."""
    arr = np.asarray(values)
    if np.issubdtype(arr.dtype, np.datetime64):
        return arr.astype("datetime64[D]").astype(np.int64).astype(np.int32)
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.int32)
    out = np.empty(len(arr), dtype=np.int32)
    for i, v in enumerate(arr):
        if isinstance(v, datetime.date):
            out[i] = days_from_civil(v.year, v.month, v.day)
        else:
            out[i] = parse_iso_date(str(v))
    return out


def parse_iso_timestamp(s: str) -> int:
    """'YYYY-MM-DD[ |T]HH:MM:SS[.frac]' (or a bare date = midnight) →
    seconds since epoch; raises ValueError on bad input."""
    s = s.strip()
    dt = datetime.datetime.fromisoformat(s.replace(" ", "T", 1) if " " in s else s)
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    days = days_from_civil(dt.year, dt.month, dt.day)
    return days * 86400 + dt.hour * 3600 + dt.minute * 60 + dt.second


def datetime_of_seconds(secs: int) -> datetime.datetime:
    return datetime.datetime(1970, 1, 1) + datetime.timedelta(seconds=int(secs))


def format_seconds(secs: int) -> str:
    """'YYYY-MM-DD HH:MM:SS' rendering."""
    return datetime_of_seconds(secs).isoformat(sep=" ")


def to_seconds_array(values) -> np.ndarray:
    """Host conversion of a datetime-ish column to int64 seconds: accepts
    datetime.datetime / datetime64 arrays / ISO strings / ints."""
    arr = np.asarray(values)
    if np.issubdtype(arr.dtype, np.datetime64):
        return arr.astype("datetime64[s]").astype(np.int64)
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.int64)
    out = np.empty(len(arr), dtype=np.int64)
    for i, v in enumerate(arr):
        if isinstance(v, datetime.datetime):
            out[i] = (
                days_from_civil(v.year, v.month, v.day) * 86400
                + v.hour * 3600 + v.minute * 60 + v.second
            )
        elif isinstance(v, datetime.date):
            out[i] = days_from_civil(v.year, v.month, v.day) * 86400
        else:
            out[i] = parse_iso_timestamp(str(v))
    return out


# ---------------------------------------------------------------------------
# The device half, on torch tensors
# ---------------------------------------------------------------------------


def _fdiv(x: torch.Tensor, k: int) -> torch.Tensor:
    """Floor division by a positive constant (jnp.floor_divide)."""
    return torch.div(x, k, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """Days since the epoch -> (year, month, day), int32 each."""
    z = z.to(torch.int32) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int32)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) int32 -> days since the epoch, int32."""
    y = y - (m <= 2).to(torch.int32)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9).to(torch.int32)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _is_leap(y: torch.Tensor) -> torch.Tensor:
    return ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Length of month m (1..12) of year y, int32: 30 or 31 by the
    month's parity (flipped from August on), 28 or 29 in February; no
    table lookup indexed by data."""
    base = 30 + ((m + (m >> 3)) & 1)
    feb = torch.where(_is_leap(y), 29, 28).to(torch.int32)
    return torch.where(m == 2, feb, base)


def _days_of_seconds(secs: torch.Tensor) -> torch.Tensor:
    return _fdiv(secs, 86400).to(torch.int32)


def ts_to_date(secs: torch.Tensor) -> torch.Tensor:
    """CAST(Timestamp AS DATE): the day, floored, as int32 days."""
    return _days_of_seconds(secs)


def _second_of_day(secs: torch.Tensor) -> torch.Tensor:
    return (secs - _fdiv(secs, 86400) * 86400).to(torch.int32)


def extract_year(days):
    return _civil_from_days(days)[0]


def extract_month(days):
    return _civil_from_days(days)[1]


def extract_day(days):
    return _civil_from_days(days)[2]


def extract_dow(days):
    """Day of week, Sunday = 0 (Postgres DOW). 1970-01-01 was a Thursday."""
    return (days.to(torch.int32) + 4) % 7


def _isoweekday(days):
    """ISO weekday, Monday = 1 .. Sunday = 7."""
    return (days.to(torch.int32) + 3) % 7 + 1


def _jan1(y):
    one = torch.ones_like(y)
    return _days_from_civil(y, one, one)


def extract_doy(days):
    y, _, _ = _civil_from_days(days)
    return days.to(torch.int32) - _jan1(y) + 1


def extract_quarter(days):
    return _fdiv(extract_month(days) - 1, 3) + 1


def extract_week(days):
    """ISO 8601 week number (1..53)."""
    y, _, _ = _civil_from_days(days)
    w = _fdiv(extract_doy(days) - _isoweekday(days) + 10, 7)

    def weeks_in(yy):
        wd = _isoweekday(_jan1(yy))
        long_year = (wd == 4) | (_is_leap(yy) & (wd == 3))
        return 52 + long_year.to(torch.int32)

    # the year-boundary adjustments both read the raw w
    w_adj = torch.where(w > weeks_in(y), 1, w)  # week 53 of a 52-week year
    return torch.where(w < 1, weeks_in(y - 1), w_adj)


def ts_extract_year(secs):
    return extract_year(_days_of_seconds(secs))


def ts_extract_month(secs):
    return extract_month(_days_of_seconds(secs))


def ts_extract_day(secs):
    return extract_day(_days_of_seconds(secs))


def ts_extract_hour(secs):
    return _fdiv(_second_of_day(secs), 3600)


def ts_extract_minute(secs):
    return _fdiv(_second_of_day(secs), 60) % 60


def ts_extract_second(secs):
    return _second_of_day(secs) % 60


def ts_extract_dow(secs):
    return extract_dow(_days_of_seconds(secs))


def ts_extract_doy(secs):
    return extract_doy(_days_of_seconds(secs))


def ts_extract_quarter(secs):
    return extract_quarter(_days_of_seconds(secs))


def ts_extract_week(secs):
    return extract_week(_days_of_seconds(secs))


def extract_epoch(days):
    return days.to(torch.int64) * 86400


def ts_extract_epoch(secs):
    return secs.to(torch.int64)


def add_months_days(days, n: int):
    """days + n calendar months, the day of the month clamped to the
    target month's length (SQL: Jan 31 + 1 MONTH = Feb 28/29)."""
    y, m, d = _civil_from_days(days)
    total = y * 12 + (m - 1) + torch.as_tensor(n, dtype=torch.int32, device=y.device)
    y2 = _fdiv(total, 12)
    m2 = total - y2 * 12 + 1
    d2 = torch.minimum(d, _days_in_month(y2, m2))
    return _days_from_civil(y2, m2, d2)


def add_months_seconds(secs, n: int):
    """seconds + n calendar months, the time of day kept."""
    d2 = add_months_days(_days_of_seconds(secs), n)
    return d2.to(secs.dtype) * 86400 + _second_of_day(secs).to(secs.dtype)


DATE_TRUNC_UNITS = ("year", "quarter", "month", "week", "day", "hour", "minute", "second")


def date_trunc_days(days, unit: str):
    """days truncated to the unit's first day (returns int32 days)."""
    d32 = days.to(torch.int32)
    if unit == "day":
        return d32
    if unit == "week":  # ISO weeks start on Monday
        return d32 - (_isoweekday(d32) - 1)
    y, m, _ = _civil_from_days(d32)
    one = torch.ones_like(y)
    if unit == "month":
        return _days_from_civil(y, m, one)
    if unit == "quarter":
        return _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    if unit == "year":
        return _days_from_civil(y, one, one)
    raise ValueError(f"unsupported DATE_TRUNC unit {unit!r}")


def date_trunc_seconds(secs, unit: str):
    """seconds truncated to the unit's start (returns seconds)."""
    if unit == "second":
        return secs
    if unit == "minute":
        return secs - secs % 60
    if unit == "hour":
        return secs - secs % 3600
    return date_trunc_days(_days_of_seconds(secs), unit).to(secs.dtype) * 86400


# the planner's names: EXTRACT fields and the INTERVAL functions
EXTRACT_FIELDS = ("year", "month", "day", "hour", "minute", "second", "dow", "doy", "quarter", "week", "epoch")
INTERVAL_FUNCTIONS = ("date_add_days", "ts_add_seconds", "add_months_days", "add_months_seconds")


def extract_function(field: str, timestamp: bool):
    """EXTRACT(field FROM x) over Date32 days (int32) or Timestamp seconds
    (int64): int32 results, EPOCH's int64."""
    return globals()[f"{'ts_' if timestamp else ''}extract_{field}"]


def trunc_function(unit: str, timestamp: bool):
    """DATE_TRUNC(unit, x), keeping x's type."""
    if timestamp:
        return lambda secs: date_trunc_seconds(secs, unit)
    return lambda days: date_trunc_days(days, unit)


def interval_function(name: str, n: int, device):
    """The planner's INTERVAL function `name` with its literal `n`: days
    plus n in int32 (wrapping), seconds plus n, or n calendar months."""
    if name == "date_add_days":
        k = torch.tensor(n, dtype=torch.int32, device=device)
        return lambda d: (d + k).to(d.dtype)
    if name == "ts_add_seconds":
        k = torch.tensor(n, dtype=torch.int64, device=device)
        return lambda d: d + k.to(d.dtype)
    if name == "add_months_days":
        return lambda d: add_months_days(d, n)
    if name == "add_months_seconds":
        return lambda d: add_months_seconds(d, n)
    raise ValueError(f"unknown INTERVAL function {name!r}")
