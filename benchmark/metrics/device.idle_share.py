"""The share of the traced window in which no operation ran on the card
(1 - the union of the trace's device operations over the window), the
mean over the cards, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_mean_s() <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_mean_s() / tr.window_s)
