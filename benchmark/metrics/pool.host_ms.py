"""Mean ms of one call spent outside the engine: in a live cell, the part
of each ``process_many`` call outside the engine's ``process_frames`` (the
pool's framing, concatenation, state handling and overlap-add), from the
harness's spans around the pool and, through the engine wrapper the pool
is handed, around the engine."""


def read(ctx):
    log = ctx["log"]
    if not log:
        return None
    return 1e3 * sum(c["t1"] - c["t0"] - c["engine_s"] for c in log) / len(log)
