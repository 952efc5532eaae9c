"""Mean ms of one engine call in its loop of graph replays (the host's
enqueue of the captured programs): the program's span ``engine.replay``,
per ``engine.process_frames`` span of the window."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, ("engine.replay",))
