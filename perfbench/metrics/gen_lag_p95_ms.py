"""gen_lag_p95_ms (ms): how late the load generator submitted requests
against their schedule, the 95th percentile over the window's requests
(the host was inside a flush when they fell due)."""
import numpy as np


def read(ctx):
    lag = getattr(ctx, "lag_ms", None)
    if lag is None or not len(lag):
        return None
    return float(np.percentile(lag, 95))
