"""Mean ms of one engine call in fetching its output: the program's span
``engine.fetch`` (the host waiting for the cards, then the copies back),
per ``engine.process_frames`` or ``engine.enhance_waveforms`` span of the
window."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, ("engine.fetch",))
