"""K1 (csrc/batched_march.cu, march_mma_kernel<true>): the least time of
its counted ray-steps at the bf16 peak over its device time."""

from port_bench.context import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "K1", "march_mma_kernel<true>")
