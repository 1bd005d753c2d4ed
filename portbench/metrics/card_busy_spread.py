"""The balance of the split over the cards (engine/call.py _widths, each
card's share of a batch, and _run_programs, which launches it):
(most busy - least busy) / most busy over the cards' busy seconds in the
traced window (the union of each card's kernel and copy intervals), in %.
Only in a run traced on the card; 0 on one card."""
MOVES = "sites_per_s"


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    busy = tr.busy_s()
    if not busy or max(busy.values()) <= 0:
        return None
    return 100.0 * (max(busy.values()) - min(busy.values())) \
        / max(busy.values())
