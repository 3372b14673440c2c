"""Thousands of points a request whose value alone K3 evaluates: the
port's k3_value_points counter (the rows of each precise_value_call,
counted on the host) over the window's requests. A request whose hits
overflow the n/4 compose bucket, with no gradient wanted, composes its
hits with K3's full sweep (compose_points.frame) and its misses with
K3's value mode: 262.144 less its hits over 1000 at 512^2. None where
no request split, or from a program without the value mode."""

from port_bench.spans import counter


def read(ctx):
    n = counter(ctx, "k3_value_points")
    return None if n is None or not ctx.answered else n / ctx.answered / 1e3
