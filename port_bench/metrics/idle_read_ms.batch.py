"""Device-idle ms per frame of the gaps that begin inside a host read of
a device value (any drt.*.read span: the rounds scheduler's fit(), the
compose bucket, the finalize branch)."""

from port_bench.spans import idle_ms, read as host_read


def read(ctx):
    return idle_ms(ctx, host_read)
