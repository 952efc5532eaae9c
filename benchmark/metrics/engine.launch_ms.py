"""Mean ms of one offline engine call in enqueueing its work: the
program's span ``engine.launch`` (front, every segment and back, over the
replicas one after another), per ``engine.enhance_waveforms`` span of the
window."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, ("engine.launch",))
