"""Drivers: one per traffic ``kind``, ``drivers/<kind>.py``, each a class
``Driver(program, traffic, seed, device)`` with

- ``span``: the name of the benchmark's span around each call into the port;
- ``warm()``: the cell's own shapes, once each (set-up);
- ``unit(i)``: unit i of the traffic (its inputs, made inside the window);
- ``run(inputs)``: one unit through the port, finished on the host;
- ``keep(i, inputs, answer)``: offer the unit's answers to the sample;
- ``end_to_end(n, span_s, latencies_s)``: the cell's end-to-end numbers;
- ``answers()``: the sampled answers, as (latent, origin, dirs, answer);
- ``work(n)``: FLOPs by stage of units 0..n-1, from untimed passes;
- ``answered(n)``: the answers the window produced (frames, requests).
"""

from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}").Driver


class Reservoir:
    """A uniform sample of ``k`` of a stream, drawn from ``rng``
    (Algorithm R): the same seed and stream give the same sample."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self) -> int:
        """The slot the next item takes, or -1 if it is not kept."""
        g = self.seen
        self.seen += 1
        if g < self.k:
            self.items.append(None)
            return g
        j = int(self.rng.integers(0, g + 1))
        return j if j < self.k else -1


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
