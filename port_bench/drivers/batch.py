"""Category-scale batches: each unit is ``latents_per_unit`` latents x
``views_per_unit`` views of ``img``^2, latent-major, through
``render_batched_c2f`` on the rounds scheduler; its answer is each
frame's depth and hit mask."""

from __future__ import annotations

import torch

from port_bench import views
from port_bench.drivers import Reservoir, synchronize


class Driver:
    span = "render_batched_c2f"

    def __init__(self, program, traffic: dict, seed: int, device):
        self.prog, self.traffic, self.seed, self.device = program, traffic, seed, device
        self.img = int(traffic["img"])
        self.per_unit = int(traffic["latents_per_unit"]) * int(traffic["views_per_unit"])
        self.sample = Reservoir(int(traffic["sample_answers"]), views.rng(seed, 3))

    def _cameras(self, i: int):
        return [views.look_at(vw, self.img, float(self.traffic["focal_scale"]), self.device)
                for vw in views.unit_views(self.traffic, self.seed, i)]

    def unit(self, i: int):
        lats = views.unit_latents(self.traffic, self.seed, i, self.prog.latent)
        rays = [views.rays(*cam, self.img) for cam in self._cameras(i)]
        nl, nv = lats.shape[0], len(rays)
        origins = torch.stack([o for o, _ in rays])            # [V, 1, 3]
        dirs = torch.stack([d for _, d in rays])               # [V, N, 3]
        return (lats.repeat_interleave(nv, dim=0),
                origins.repeat(nl, 1, 1), dirs.repeat(nl, 1, 1))

    def run(self, inputs):
        st = self.prog.render_batch(*inputs)
        synchronize(self.device)
        return st

    def warm(self) -> None:
        self.run(self.unit(-1))

    def keep(self, i: int, inputs, st) -> None:
        for f in range(self.per_unit):
            slot = self.sample.offer()
            if slot >= 0:
                self.sample.items[slot] = (i, f, st.depth[f].clone(), st.hit[f].clone())

    def answers(self):
        for i, f, depth, hit in self.sample.items:
            lats, origins, dirs = self.unit(i)
            yield (lats[f], origins[f], dirs[f],
                   {"depth": depth, "hit": hit, "normal": None}, f"unit {i} frame {f}")

    def answered(self, n: int) -> int:
        return n * self.per_unit

    def end_to_end(self, n: int, span_s: float, latencies_s) -> dict:
        rays = n * self.per_unit * self.img * self.img
        return {"mrays_per_s": rays / span_s / 1e6}

    def work(self, n: int) -> dict:
        total = {}
        for i in range(n):
            steps = self.prog.batch_work(*self.unit(i))
            for k, v in self.prog.flops(steps).items():
                total[k] = total.get(k, 0.0) + v
        total["compose"] = 0.0   # no compose on this path
        return {"K1": total["coarse"] + total["fine"] + total["verify"], "all": sum(
            total.values()), **total}
