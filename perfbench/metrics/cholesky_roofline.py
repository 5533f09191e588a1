"""cholesky_roofline (%): the Cholesky factorization of W + λI
(``kernels/cholesky.py``) against its roofline: the device time of every
operation launched inside the window's ``ops.cholesky`` calls (the
kernel and its memset), against n³/3 operations or the two triangles'
bytes."""
from perfbench import roofline as rf


def read(ctx):
    calls = len(ctx.layers.get("pb.cholesky", ()))
    secs = ctx.trace.seconds_under("pb.cholesky") if ctx.trace else 0.0
    if not calls or secs <= 0.0:
        return None
    c = ctx.config
    return rf.share(rf.cholesky(c["n"]).times(calls), secs, c["dtype"])
