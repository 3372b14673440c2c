"""Device-idle ms per request of the gaps that begin inside the fine
schedulers' spans: drt.fine* (the proxy's fine march, K2) and drt.verify*
(its plan, the full-decoder march, the merge)."""

from port_bench.spans import idle_ms, march


def read(ctx):
    return idle_ms(ctx, march)
