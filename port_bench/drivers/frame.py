"""Served frames, one client in a closed loop: each unit is one request
(``latents_per_unit`` = ``views_per_unit`` = 1) rendered by ``render()``
as the port's server does, finished on the card, and answered with
depth and mask copied to the host. A request's latency runs from the
client's call to that answer."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import views
from port_bench.drivers import Reservoir, synchronize


class Driver:
    span = "render"

    def __init__(self, program, traffic: dict, seed: int, device):
        self.prog, self.traffic, self.seed, self.device = program, traffic, seed, device
        self.img = int(traffic["img"])
        self.sample = Reservoir(int(traffic["sample_answers"]), views.rng(seed, 3))

    def unit(self, i: int):
        z = views.unit_latents(self.traffic, self.seed, i, self.prog.latent)[0]
        view = views.unit_views(self.traffic, self.seed, i)[0]
        K, R, T = views.look_at(view, self.img, float(self.traffic["focal_scale"]), self.device)
        return z, (K, R, T)

    def run(self, inputs):
        z, krt = inputs
        out = self.prog.render_frame(z, self.prog.camera(*krt))
        synchronize(self.device)
        with record_function("d2h"):
            depth, mask = out.depth.cpu(), out.mask.cpu()
        return out, depth, mask

    def warm(self) -> None:
        for i in range(int(self.traffic.get("warm_units", 2))):
            self.run(self.unit(-1 - i))

    def keep(self, i: int, inputs, answer) -> None:
        slot = self.sample.offer()
        if slot >= 0:
            out, depth, mask = answer
            self.sample.items[slot] = (i, depth, mask, out.normal.clone())

    def answers(self):
        for i, depth, mask, normal in self.sample.items:
            z, krt = self.unit(i)
            o, v = views.rays(*krt, self.img)
            yield (z, o, v, {"depth": depth.to(self.device), "hit": mask.to(self.device),
                             "normal": normal}, f"request {i}")

    def answered(self, n: int) -> int:
        return n

    def end_to_end(self, n: int, span_s: float, latencies_s) -> dict:
        return {"frames_per_s": n / span_s,
                "frame_ms_p95": 1e3 * float(np.percentile(np.asarray(latencies_s), 95))}

    def work(self, n: int) -> dict:
        total = {}
        for i in range(n):
            z, krt = self.unit(i)
            steps = self.prog.frame_trace_work(z, self.prog.camera(*krt))
            for k, v in self.prog.flops(steps).items():
                total[k] = total.get(k, 0.0) + v
        return {"K1": total["coarse"], "K2": total["fine"] + total["verify"],
                "all": sum(total.values()), **total}
