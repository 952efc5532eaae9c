"""The model's share of the cards' float32 peak while the program runs:
the network's FLOPs of the frames the calls completed in the window (the
valid, unpadded frames of each stream; ``work.dpdfnet.frame_flops_total``
each) over the calls' summed wall time x the published float32 peak x
the cards, in %.  A live cell's calls leave the waits for due hops out;
an offline cell's closed loop leaves only the host's steps between
calls out."""

from benchmark.work import dpdfnet


def read(ctx):
    done = [c for c in ctx["log"] if c["in_window"]]
    peaks = ctx["peaks"]
    if not done or peaks is None:
        return None
    flops = dpdfnet.frame_flops_total(ctx["config"]) * sum(c["frames"] for c in done)
    wall = sum(c["t1"] - c["t0"] for c in done)
    return 100.0 * flops / (wall * peaks["f32_flops"] * ctx["chips"])
