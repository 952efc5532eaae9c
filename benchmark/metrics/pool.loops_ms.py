"""Mean ms of one ``process_many`` call in the pool's own loops: the
program's spans ``pool.stage`` (validate, downmix, append, group),
``pool.frame`` (the frames of each hop bucket) and ``pool.overlap_add``,
per ``pool.process_many`` span of the window."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.ms_per_call(ctx, ("pool.stage", "pool.frame", "pool.overlap_add"),
                                     ("pool.process_many",))
