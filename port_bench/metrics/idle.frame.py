"""The device's idle share of the traced window: 1 - the union of the
device operations' intervals / the window."""

from port_bench.context import idle_pct as read
