"""Speed-of-light roofline accounting per operator.

Port of datafusion_tpu/utils/roofline.py: every operator's data movement
is accounted against the card's memory bandwidth, to report the achieved
fraction of the roofline. The cost model (`OpCost` and the three cost
functions) is the JAX package's, term for term; the bandwidth table is
NVIDIA's published HBM figures for the Hopper parts, keyed on the name
`torch.cuda.get_device_name` reports. A card the table does not know,
or no card at all, raises: there is no default bandwidth to fall back on.
Beside it, the NVLink figure each way per card (`chip_nvlink_gbps`),
the rate at which a card reads a peer card's memory (K5 / K6 across the
cards of a mesh, parallel/mesh.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# HBM bandwidth in GB/s (NVIDIA's data sheets), by a substring of the
# card's name; the more specific names come first
CHIP_HBM_GBPS = {
    "H100 NVL": 3900.0,
    "H100 PCIe": 2000.0,
    "H100 80GB HBM3": 3350.0,  # the SXM part's name in torch.cuda.get_device_name
    "H100 SXM": 3350.0,
}


# NVLink bandwidth each way per card in GB/s (NVIDIA's data sheets: the
# SXM part's 900 GB/s to the other cards of its host, all to all, is
# 450 GB/s each way), by a substring of the card's name
CHIP_NVLINK_GBPS = {
    "H100 80GB HBM3": 450.0,  # the SXM part's name in torch.cuda.get_device_name
    "H100 SXM": 450.0,
}


def _lookup(table: dict, what: str, device) -> float:
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"no {what} bandwidth for device {device}: the roofline is the card's")
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: the roofline is the card's")
    name = torch.cuda.get_device_name(device)
    for key, bw in table.items():
        if key in name:
            return bw
    raise ValueError(f"no published {what} bandwidth for {name!r}")


def chip_hbm_gbps(device=None) -> float:
    """The HBM bandwidth of the card `device` (default: the current one),
    in GB/s. Raises on the CPU and on a card the table does not name."""
    return _lookup(CHIP_HBM_GBPS, "HBM", device)


def chip_nvlink_gbps(device=None) -> float:
    """The NVLink bandwidth each way of the card `device` (default: the
    current one) to the other cards of its host, in GB/s. Raises on the
    CPU and on a card the table does not name."""
    return _lookup(CHIP_NVLINK_GBPS, "NVLink", device)


@dataclass(frozen=True)
class OpCost:
    """Bytes moved by one operator invocation (reads + writes)."""

    name: str
    bytes_read: int
    bytes_written: int

    @property
    def bytes_total(self) -> int:
        return self.bytes_read + self.bytes_written


def filter_project_cost(n_rows: int, read_cols_bytes: int, written_cols_bytes: int) -> OpCost:
    """Fused scan -> filter -> project: reads the referenced columns,
    writes the computed columns and a 1-byte selection mask. Pass per-row
    byte widths."""
    return OpCost("filter_project", n_rows * read_cols_bytes, n_rows * (written_cols_bytes + 1))


def sort_cost(n_rows: int, row_bytes: int, passes: int = 1) -> OpCost:
    """A sort reads and writes its payload once per logical pass."""
    return OpCost("sort", n_rows * row_bytes * passes, n_rows * row_bytes * passes)


def grouped_agg_cost(n_rows: int, key_bytes: int, agg_bytes: int) -> OpCost:
    """Sort-based grouped aggregation: one co-sort pass of keys and
    arguments plus one segmented-reduce read."""
    per_row = key_bytes + agg_bytes + 5  # row index and selection
    return OpCost("grouped_aggregate", n_rows * per_row * 2, n_rows * per_row)


def roofline_seconds(cost: OpCost, bw_gbps: float | None = None) -> float:
    bw = (bw_gbps or chip_hbm_gbps()) * 1e9
    return cost.bytes_total / bw


def achieved_fraction(cost: OpCost, measured_seconds: float, bw_gbps: float | None = None) -> float:
    return roofline_seconds(cost, bw_gbps) / max(measured_seconds, 1e-12)
