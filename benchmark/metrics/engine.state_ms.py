"""Mean ms of one engine call in copying the stream state into the
captured graphs' slot and out again: the program's spans
``engine.state_in`` and ``engine.state_out``, per ``engine.process_frames``
span of the window."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, ("engine.state_in", "engine.state_out"))
