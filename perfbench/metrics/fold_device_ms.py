"""fold_device_ms (ms): device time of the adaptation a fold: every
operation launched inside the window's ``OnlineAdaptation.fold`` and
``maybe_refresh`` calls (``serve/adapt.py``, ``curvature/update.py``:
the fold's cross pass, the rank-k update and downdate, the window's copy,
the refreshes), over the folds."""


def read(ctx):
    folds = getattr(ctx, "folds", 0)
    if ctx.trace is None or not folds:
        return None
    secs = ctx.trace.seconds_under("pb.fold", "pb.maintain")
    return 1e3 * secs / folds if secs > 0.0 else None
