"""trisolve_roofline (%): the substitution w = L⁻ᵀ L⁻¹ u of a one-shot
solve (``kernels/serve_solve.py``, ``ops.trisolve``) against its
roofline: 2n² operations or L's lower triangle and u, w once."""
from perfbench import roofline as rf


def read(ctx):
    calls = len(ctx.layers.get("pb.trisolve", ()))
    secs = ctx.trace.seconds_under("pb.trisolve") if ctx.trace else 0.0
    if not calls or secs <= 0.0:
        return None
    c = ctx.config
    return rf.share(rf.trisolve(c["n"]).times(calls), secs, c["dtype"])
