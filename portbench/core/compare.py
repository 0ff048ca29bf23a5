"""The comparison that decides `correct`: a result's rows against the
plain reference's, column by column.

Two numbers come out of it, each held to a limit of its own:
  exact_mismatch  cells of the non-float columns (keys, counts, strings,
                  dates), row counts and NULLs that differ; limit 0.
  float_err       the widest gap of a float cell from the reference's,
                  relative to the reference's value, in units of 2^-53
                  (float64's unit roundoff) whatever the column's type,
                  so that one limit means the same on every column.
A result whose row order SQL leaves open (no ORDER BY) is compared after
both sides are sorted by every column, the non-float ones first."""

from __future__ import annotations

import numpy as np
import torch

UNIT = 2.0 ** -53
TINY = np.finfo(np.float64).tiny


def port_columns(res) -> list[np.ndarray]:
    """The port's ResultTable as host columns: strings decoded, dates as
    days since 1970-01-01, NULLs as None (an object column then)."""
    out = []
    for j, (data, valid) in enumerate(res.cols):
        vocab = res.dicts[j]
        col = np.asarray(vocab, dtype=object)[np.asarray(data)] if vocab is not None else np.asarray(data)
        if valid is not None and not np.all(valid):
            col = col.astype(object)
            col[~np.asarray(valid)] = None
        out.append(col)
    return out


def _is_float(col: np.ndarray) -> bool:
    return col.dtype.kind == "f"


def _sort_key(col: np.ndarray, device) -> torch.Tensor:
    if col.dtype.kind == "O":
        col = np.unique(np.array(["\0" if v is None else str(v) for v in col]), return_inverse=True)[1]
    elif col.dtype.kind == "u":
        col = col.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(col)).to(device)


def canonical(cols: list[np.ndarray], device="cpu") -> list[np.ndarray]:
    """Rows sorted by every column, the non-float columns first (stable
    sorts in torch on `device`, least significant key first)."""
    if not cols or len(cols[0]) < 2:
        return cols
    keys = [c for c in cols if not _is_float(c)] + [c for c in cols if _is_float(c)]
    perm = None
    for c in reversed(keys):
        k = _sort_key(c, device)
        if perm is not None:
            k = k[perm]
        idx = torch.sort(k, stable=True).indices
        perm = idx if perm is None else perm[idx]
    p = perm.cpu().numpy()
    return [c[p] for c in cols]


def compare(got: list[np.ndarray], want: list[np.ndarray], ordered: bool, device="cpu") -> tuple[int, float]:
    """(exact_mismatch, float_err) of `got` against `want`."""
    rows_g = len(got[0]) if got else 0
    rows_w = len(want[0]) if want else 0
    if len(got) != len(want) or rows_g != rows_w:
        return max(rows_g, rows_w, 1) * max(len(got), len(want), 1), 0.0
    if not ordered:
        got, want = canonical(got, device), canonical(want, device)
    exact, err = 0, 0.0
    for g, w in zip(got, want):
        if _is_float(g) and w.dtype.kind in "fO":
            if w.dtype.kind == "O":  # NULLs on the reference's side
                nul = np.array([v is None for v in w])
                exact += int(nul.sum())
                w = np.where(nul, np.nan, w).astype(np.float64)
            gd, wd = g.astype(np.float64), w.astype(np.float64)
            both_nan = np.isnan(gd) & np.isnan(wd)
            same = (gd == wd) | both_nan
            gap = np.where(same, 0.0, np.abs(gd - wd) / np.maximum(np.abs(wd), TINY))
            gap = np.where(np.isnan(gap), np.inf, gap)
            if gap.size:
                err = max(err, float(gap.max()) / UNIT)
        elif g.dtype.kind == "O" or w.dtype.kind == "O":
            exact += sum(1 for a, b in zip(g.tolist(), w.tolist()) if not _same(a, b))
        else:
            exact += int(np.count_nonzero(g != w))
    return exact, err


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, float) or isinstance(b, float):
        return float(a) == float(b)
    return a == b
