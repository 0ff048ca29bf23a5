"""Date32 / Timestamp host conversions: days since the Unix epoch
(1970-01-01) and seconds since the epoch <-> civil calendar.

Only the host (numpy / Python) side is carried here: ingest parsing,
literal planning and result rendering. Device-side date arithmetic
(EXTRACT, DATE_TRUNC, interval arithmetic) is not part of the port yet.
The civil<->days conversion is Howard Hinnant's public-domain era-based
algorithm.
"""

from __future__ import annotations

import datetime

import numpy as np


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
