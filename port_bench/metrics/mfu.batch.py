"""The whole batch's share of the bf16 peak: 2 x MACs of every ray-step
the marches report (pyramid, fine and verify, each at its network's
folded MACs) / (traced window x 989 TFLOP/s)."""

from port_bench.context import mfu_pct as read
