"""gram_roofline (%): the Gram pass of Algorithm 1 (``kernels/gram.py``,
``ops.gram_sv``: W = S Sᵀ and u = S v in one pass) against its roofline:
the device time of every operation launched inside the window's
``gram_sv`` calls, against the least time of their work at the
configuration's tensor-core peak or the memory's rate."""
from perfbench import roofline as rf


def read(ctx):
    calls = len(ctx.layers.get("pb.gram_sv", ()))
    secs = ctx.trace.seconds_under("pb.gram_sv") if ctx.trace else 0.0
    if not calls or secs <= 0.0:
        return None
    c = ctx.config
    work = rf.gram_sv(c["n"], c["m"], c["dtype"]).times(calls)
    return rf.share(work, secs, c["dtype"])
