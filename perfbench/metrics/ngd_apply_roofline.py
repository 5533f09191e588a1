"""ngd_apply_roofline (%): the apply pass x = (v − Sᵀw)/λ
(``kernels/ngd_apply.py``) against its roofline: S, w, v read and x
written once."""
from perfbench import roofline as rf


def read(ctx):
    calls = len(ctx.layers.get("pb.ngd_apply", ()))
    secs = ctx.trace.seconds_under("pb.ngd_apply") if ctx.trace else 0.0
    if not calls or secs <= 0.0:
        return None
    c = ctx.config
    work = rf.ngd_apply(c["n"], c["m"], c["dtype"]).times(calls)
    return rf.share(work, secs, c["dtype"])
