"""Device-idle ms per request of the gaps that begin inside drt.compose*
(render_rays' composition: the bucket's host read, K3) or
drt.finalize*."""

from port_bench.spans import compose, idle_ms


def read(ctx):
    return idle_ms(ctx, compose)
