"""microbatch_solve_ms (ms): the median time of a microbatch's solve as
the server records it (its ``device_solve`` span of ``repro_torch.obs``'s
tracer: a host clock ended by the server's own wait on the device), over
the window's microbatches."""
import numpy as np


def read(ctx):
    spans = getattr(ctx, "solve_spans_ms", None)
    if not spans:
        return None
    return float(np.median(spans))
