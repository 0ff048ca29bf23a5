"""Compiled pipeline (host side): CUDA runtime calls that block the host
on a card (synchronizes, blocking copies) inside the port's `dft.sql`
spans, per query (`core/hostspans.py`)."""

from portbench.core import hostspans

hostspans.install()


def read(t):
    side = hostspans.of(t)
    if not t.queries or side is None or not side.sql_spans:
        return None
    return side.host_syncs / t.queries
