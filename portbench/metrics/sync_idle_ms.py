"""Compiled pipeline (host side): device idle milliseconds per query,
summed over the cards, in the gaps that open while the host waits in a
blocking call inside `dft.sql`: the card's queue drained by a host read,
not a host that was merely slower than the card (`core/hostspans.py`)."""

from portbench.core import hostspans

hostspans.install()


def read(t):
    side = hostspans.of(t)
    if not t.queries or side is None or not side.sql_spans:
        return None
    return side.sync_idle_ns / 1e6 / t.queries
