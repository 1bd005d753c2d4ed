"""Device: 1 - busy / window per card, busy the union of its kernel and
copy intervals in the traced window, the mean over the cards, in %."""
MOVES = "sites_per_s"


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    busy = tr.busy_s()
    if not busy:
        return None
    return 100.0 * sum(1.0 - b / tr.window_s for b in busy.values()) \
        / len(busy)
