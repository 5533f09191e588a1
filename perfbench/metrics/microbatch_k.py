"""microbatch_k (requests): requests a microbatch served, the server's
own counts (``ServeStats.served / microbatches``) over the window."""


def read(ctx):
    if not getattr(ctx, "microbatches", 0):
        return None
    return ctx.served / ctx.microbatches
