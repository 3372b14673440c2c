"""Device-idle ms per request of the traced window's gaps that begin
inside drt.setup or drt.plan.* (the innermost span open at the gap's
start)."""

from port_bench.spans import idle_ms, plan


def read(ctx):
    return idle_ms(ctx, plan)
