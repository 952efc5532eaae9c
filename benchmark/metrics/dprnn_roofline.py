"""The DPRNN stages' share of their roofline: the least time the stages of
the frames every call ran could take (each call's ``launches`` =
``[streams, frames, count]``: ``count`` launches a stage over streams x
frames of valid, unpadded audio; per launch the larger of FLOPs over the
float32 peak and bytes over the memory rate, ``work.dpdfnet.dprnn_bound_s``)
over the device time of the kernels that ran them, matched by ``NAMES``,
in %.  The work counted is the stages', whatever kernel runs them; padded
frames count as time and not as work."""

from benchmark.work import dpdfnet

NAMES = ("dprnn_intra", "dprnn_inter", "dprnn_stack", "relayout_fm", "gru_bidir")


def read(ctx):
    tr, log, peaks, cfg = ctx["trace"], ctx["log"], ctx["peaks"], ctx["config"]
    if tr is None or not log or peaks is None:
        return None
    spent = tr.time_matching(NAMES)
    if spent <= 0.0:
        return None
    bound = sum(n * dpdfnet.dprnn_bound_s(cfg, b, t, peaks["f32_flops"], peaks["bytes_per_s"])
                for b, t, n in (c["launches"] for c in log))
    return 100.0 * bound / spent
