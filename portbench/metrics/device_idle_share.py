"""Device: the share of the traced window in which a card ran nothing,
averaged over the cell's cards, in percent."""


def read(t):
    busy = t.busy_s()
    if t.window_s <= 0 or not t.events:
        return None
    return 100.0 * sum(1.0 - b / t.window_s for b in busy.values()) / len(busy)
