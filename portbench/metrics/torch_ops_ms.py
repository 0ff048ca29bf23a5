"""Torch operators: device milliseconds per query of PyTorch's own kernels
(memcpy and memset excluded), summed over the cards."""


def read(t):
    if not t.queries or not t.count(("torch",)):
        return None
    return t.time_s(("torch",)) * 1e3 / t.queries
