"""Materialization: device-to-host copy milliseconds per query, summed
over the cards."""


def read(t):
    if not t.queries or not t.count(("d2h",)):
        return None
    return t.time_s(("d2h",)) * 1e3 / t.queries
