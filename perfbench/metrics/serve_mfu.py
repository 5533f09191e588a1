"""serve_mfu (%): the whole served window against the card: the least
time of the window's work — each microbatch's solve and each fold and
refresh, at its operations over the configuration's tensor-core peak or
its bytes over the memory's rate, whichever bounds it — over the traced
window's time."""
from perfbench import roofline as rf


def read(ctx):
    if ctx.trace is None or not ctx.microbatches:
        return None
    c, t = ctx.config, ctx.traffic
    n, m, dt = c["n"], c["m"], c["dtype"]
    least = sum(rf.least_seconds(rf.serve_solve(n, m, k, dt), dt)[0]
                for (k,) in ctx.layers.get("pb.serve_solve", ()))
    rows = int(t.get("rows_per_request", 0))
    if rows:
        least += ctx.folds * rf.least_seconds(rf.fold(n, m, rows, dt), dt)[0]
    least += ctx.refreshes * rf.least_seconds(rf.refresh(n, m, dt), dt)[0]
    return 100.0 * least / ctx.trace.window_s
