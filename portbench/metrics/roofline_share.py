"""Port kernels and device: the traced queries' least bytes (each base
column they name read once, each result written once) over what the
cards' published HBM rate moves in their busy time, in percent. Over
several cards, the rate times the busy time is summed over the cards."""


def read(t):
    busy = t.busy_s()
    cap = t.hbm_bytes_per_s * sum(busy.values())
    if not t.queries or cap <= 0 or t.least_bytes <= 0:
        return None
    return 100.0 * t.least_bytes / cap
