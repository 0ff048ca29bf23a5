"""Kernel wrappers: host milliseconds per query in the wrappers' own
work (checks, tables, launch arguments): the self time of the
`dft.kernel.*` spans, less the program spans inside them
(`core/hostspans.py`)."""

from portbench.core import hostspans

hostspans.install()


def read(t):
    side = hostspans.of(t)
    if not t.queries or side is None or not side.kernel_spans:
        return None
    return side.wrapper_self_ns / 1e6 / t.queries
