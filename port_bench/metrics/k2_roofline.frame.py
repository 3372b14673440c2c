"""K2's generations (csrc/queue_march.cu, queue_generation_kernel): the
least time of the fine and verify stages' counted ray-steps at the bf16
peak over their device time."""

from port_bench.context import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "K2", "queue_generation_kernel")
