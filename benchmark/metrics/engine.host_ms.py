"""Mean ms of one engine call (the span ``engine_s`` of each call: a live
cell's ``process_frames``, an offline cell's ``enhance_waveforms``) less
the card's busy time per call (the union of the trace's device
operations over the window, averaged over the cards, shared out over the
calls): the host work around the device's, padding, copies, graph
replays and dispatch included."""


def read(ctx):
    tr = ctx["trace"]
    calls = [c for c in ctx["log"] if c["engine_s"] > 0.0]
    if tr is None or not calls or tr.busy_mean_s() <= 0.0:
        return None
    return 1e3 * (sum(c["engine_s"] for c in calls) - tr.busy_mean_s()) / len(calls)
