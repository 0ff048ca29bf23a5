"""Mesh over cards: megabytes per query that the collectives copy between
cards (the port's `to_card.bytes` counter)."""


def read(t):
    moved = t.counters.get("to_card_bytes", 0)
    if not t.queries or moved <= 0:
        return None
    return moved / 1e6 / t.queries
