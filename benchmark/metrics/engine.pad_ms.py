"""Mean ms of one offline engine call in padding and unpadding on the
host: the program's spans ``engine.pad`` (bucket, zero-pad, the uploads)
and ``engine.unpad`` (output zeroed past each length), per
``engine.enhance_waveforms`` span of the window.  The copy back
synchronises, so the cards wait for this work."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, ("engine.pad", "engine.unpad"))
