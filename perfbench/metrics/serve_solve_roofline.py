"""serve_solve_roofline (%): a microbatch's solve against the resident
factor (``kernels/serve_solve.py``: the cross pass, the substitution and
the apply pass, as one step) against its roofline: for each call, S, L's
lower triangle, V read and X written once, or 4nmk + 2n²k operations,
whichever bounds it, k being the width the server handed the call."""
from perfbench import roofline as rf


def read(ctx):
    calls = ctx.layers.get("pb.serve_solve", ())
    secs = ctx.trace.seconds_under("pb.serve_solve") if ctx.trace else 0.0
    if not calls or secs <= 0.0:
        return None
    c = ctx.config
    least = sum(rf.least_seconds(rf.serve_solve(c["n"], c["m"], k,
                                                c["dtype"]), c["dtype"])[0]
                for (k,) in calls)
    return 100.0 * least / secs
