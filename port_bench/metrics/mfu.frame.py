"""The served frames' share of the bf16 peak: the marches' ray-steps as
in mfu.batch, plus one decoder forward for each hit compose recomputes."""

from port_bench.context import mfu_pct as read
