"""Host ms per request inside the port's set-up and c2f planning spans
(drt.setup: rays, latent folds, bias banks; drt.plan.*: each pyramid
level's K1 launch and windows, the maps and the plan): the union of
their intervals in the traced window."""

from port_bench.spans import host_ms, plan


def read(ctx):
    return host_ms(ctx, plan)
