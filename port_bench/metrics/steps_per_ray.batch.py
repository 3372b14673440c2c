"""Ray-steps per pixel ray: the port's ray_steps counter (every march
launch's steps_per_ray summed on the card: the pyramid's levels, the
fine and verify rounds) over its rays counter (frames x pixels)."""

from port_bench.spans import counter


def read(ctx):
    steps, rays = counter(ctx, "ray_steps"), counter(ctx, "rays")
    return None if steps is None or not rays else steps / rays
