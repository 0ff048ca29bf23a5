"""Plain PyTorch helpers of the references: groups, their sums and
extremes, row orders, and the host form of a result column.
`F` is the float type every float computation runs in: float64 for the
reference, float32 for the control."""

from __future__ import annotations

import numpy as np
import torch

OUT = {"f32": np.float32, "f64": np.float64, "i32": np.int32, "i64": np.int64, "u64": np.uint64}


def groups(*keys: torch.Tensor) -> tuple[torch.Tensor, int, list[torch.Tensor]]:
    """Group rows by the tuple of (non-negative integer) keys, groups in
    ascending key order: (group of each row, number of groups, each key's
    value per group)."""
    comb = torch.zeros_like(keys[0], dtype=torch.int64)
    for k in keys:
        span = int(k.max()) + 1 if k.numel() else 1
        comb = comb * span + k.to(torch.int64)
    uniq, inv = torch.unique(comb, sorted=True, return_inverse=True)
    n = int(uniq.numel())
    vals = []
    for k in keys:
        v = torch.zeros(n, dtype=k.dtype, device=k.device)
        v[inv] = k
        vals.append(v)
    return inv, n, vals


FEW_GROUPS = 4096


def gsum(inv: torch.Tensor, n: int, x: torch.Tensor) -> torch.Tensor:
    """Per-group sums. Up to FEW_GROUPS groups, each group's values are
    summed by one reduction (a tree, so the rounding error stays near one
    unit however many rows a group holds); above, where groups are small,
    by atomic adds."""
    if n > FEW_GROUPS:
        return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, inv, x)
    order = torch.sort(inv, stable=True).indices
    xs = x[order]
    counts = torch.bincount(inv, minlength=n).tolist()
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    at = 0
    for g, c in enumerate(counts):
        if c:
            out[g] = xs[at:at + c].sum()
        at += c
    return out


def gcount(inv: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(inv, minlength=n)


def gext(inv: torch.Tensor, n: int, x: torch.Tensor, how: str) -> torch.Tensor:
    """Per-group MIN ("amin") or MAX ("amax")."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).scatter_reduce_(0, inv, x, how, include_self=False)


def order(*keys: tuple[torch.Tensor, bool]) -> torch.Tensor:
    """Row order by (key, descending) pairs, the first pair most
    significant, ties kept in row order."""
    n = keys[0][0].numel()
    perm = torch.arange(n, device=keys[0][0].device)
    for k, desc in reversed(keys):
        _, idx = torch.sort(k[perm], stable=True, descending=desc)
        perm = perm[idx]
    return perm


def host(x: torch.Tensor, kind: str) -> np.ndarray:
    """A result column on the host in its SQL type's width."""
    return x.detach().cpu().numpy().astype(OUT[kind])
