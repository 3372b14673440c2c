"""Device ms per frame of every operation not built from the port's CUDA
sources: the fine schedulers' sorts, gathers and merges, copies, sets."""

from port_bench.context import glue_ms_per_answer as read
