"""solve_mfu (%): the whole one-shot solve against the card's peak: the
operations Algorithm 1 needs at the cell's shapes (the Gram's lower
triangle and u, the Cholesky, the substitution, the apply) times the
solves of the traced window, over the window's time at the
configuration's tensor-core peak."""
from perfbench import roofline as rf


def read(ctx):
    if ctx.trace is None or not ctx.solves:
        return None
    c = ctx.config
    flops = rf.algorithm1(c["n"], c["m"], c["dtype"]).flops * ctx.solves
    return 100.0 * flops / (ctx.trace.window_s * rf.peak_flops(c["dtype"]))
