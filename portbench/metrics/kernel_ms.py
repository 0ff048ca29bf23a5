"""Port kernels: device milliseconds per query of every kernel that is not
PyTorch's own, summed over the cards."""


def read(t):
    if not t.queries or not t.count(("port",)):
        return None
    return t.time_s(("port",)) * 1e3 / t.queries
