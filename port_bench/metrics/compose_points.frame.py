"""Thousands of points K3 evaluates per request: the port's k3_points
counter (the rows of each precise_sdg_call, counted on the host) over
the window's requests. 65.536 where every request's hits fit the n/4
compose bucket at 512^2, 262.144 where none do."""

from port_bench.spans import counter


def read(ctx):
    n = counter(ctx, "k3_points")
    return None if n is None or not ctx.answered else n / ctx.answered / 1e3
