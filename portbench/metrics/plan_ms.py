"""Front end: parse + plan milliseconds per query (`last_stats`)."""


def read(t):
    return t.plan_s * 1e3 / t.queries if t.queries else None
