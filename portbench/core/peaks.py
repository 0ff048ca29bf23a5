"""The table of peaks: NVIDIA's published HBM rate of each card, by a
substring of the name `torch.cuda.get_device_name` gives (the more
specific names first). A card the table does not name has no roofline."""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = {
    "H100 NVL": 3.9e12,
    "H100 PCIe": 2.0e12,
    "H100 80GB HBM3": 3.35e12,  # the SXM part
    "H100 SXM": 3.35e12,
}


def hbm_bytes_per_s(card_name: str) -> Optional[float]:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in card_name:
            return rate
    return None
