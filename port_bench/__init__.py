"""The benchmark of the PyTorch and CUDA port (``dist_renderer_tpu_torch``).

One command runs one cell (a configuration under a traffic mix, as
``BENCHMARK.json`` at the root of the checkout names them) once::

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (read by the
driver that its ``kind`` names, ``drivers/<kind>.py``),
``limits/<cell>.json`` (the limits of the comparison that decides
``correct``) and ``metrics/<metric>.py`` (a reader with
``read(ctx) -> float | None``). ``reference/`` is the plain float32
reference, which imports nothing of the port.
"""
