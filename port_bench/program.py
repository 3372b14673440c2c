"""The system under test, built from a configuration file: the port's
decoder and optional proxy loaded from the committed weight files, its
march and render settings, and the two entries the traffic drives,
``render_batched_c2f`` (batches) and ``render`` (served frames).

Nothing is fitted or distilled here: a missing weight file fails the
run. The proxy's verify margins are the port's own set-up
(``proxy_march_margins`` on the error report stored in its file).
"""

from __future__ import annotations

import os

import torch

from port_bench.work import decoder_macs


class Program:
    def __init__(self, cfg: dict, root: str, img: int, device: torch.device):
        from dist_renderer_tpu_torch.config import (
            DecoderConfig, GradConfig, MarchConfig, RenderConfig,
        )
        from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul
        from dist_renderer_tpu_torch.models.pretrain import load_params_npz
        from dist_renderer_tpu_torch.ops.kernels import batched_march as bm

        set_fp32_matmul()
        self.cfg, self.img, self.device = cfg, img, device
        spec = cfg["decoder"]
        self.params, self.latent = load_params_npz(self._file(root, spec["file"]), device)
        self.dcfg = DecoderConfig(latent_size=int(spec["latent_size"]),
                                  hidden_dims=tuple(int(d) for d in spec["hidden_dims"]),
                                  latent_in=tuple(int(i) for i in spec.get("latent_in", ())),
                                  final_tanh=bool(spec.get("final_tanh", True)))
        shapes = [tuple(l["w"].shape) for l in self.params["layers"]]
        if shapes != list(self.dcfg.layer_dims):
            raise ValueError(f"{spec['file']}: layer shapes {shapes} are not the "
                             f"configuration's {list(self.dcfg.layer_dims)}")
        march = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["march"].items()}
        self.macs = {"decoder": decoder_macs(spec)}
        self.proxy = None
        if cfg.get("proxy"):
            from dist_renderer_tpu_torch.models.proxy import (
                load_proxy_meta, load_proxy_npz, proxy_march_margins,
            )
            path = self._file(root, cfg["proxy"]["file"])
            self.proxy = load_proxy_npz(path, device)
            march["proxy_backoff"], march["proxy_band"] = proxy_march_margins(
                load_proxy_meta(path), float(cfg["proxy"]["margins_eps"]))
            p = self.proxy[1]
            self.macs["proxy"] = decoder_macs(dict(
                latent_size=p.latent_size, hidden_dims=p.hidden_dims,
                latent_in=p.latent_in, xyz_in_all=p.xyz_in_all))
        self.march = MarchConfig(**march)
        self.render_cfg = RenderConfig(
            img_h=img, img_w=img, march=self.march, grad=GradConfig(**cfg["grad"]),
            compute_dtype=cfg["compute_dtype"], use_pallas=bool(cfg["use_pallas"]))
        self.packed = (bm.pack_shared(self.params, self.dcfg),
                       None if self.proxy is None else bm.pack_shared(*self.proxy))
        self._factory = None

    @staticmethod
    def _file(root: str, rel: str) -> str:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            raise FileNotFoundError(f"{rel}: the configuration's weight file is not in "
                                    f"the checkout (the benchmark fits nothing)")
        return path

    @property
    def march_macs(self) -> int:
        """MACs of one evaluation of the network the pyramid and the fine
        march step: the proxy where there is one."""
        return self.macs["proxy" if self.proxy is not None else "decoder"]

    def _batched_kw(self, march=None) -> dict:
        m = march or self.march
        return dict(strides=m.c2f_strides, coarse_steps=m.c2f_coarse_steps,
                    backoff=m.c2f_backoff, proxy=self.proxy,
                    proxy_backoff=m.proxy_backoff, proxy_band=m.proxy_band,
                    verify_round_caps=m.proxy_verify_caps, shared_origin=True,
                    packed=self.packed, persistent=True)

    @torch.no_grad()
    def render_batch(self, latents, origins, dirs, **extra):
        """The batched entry: render_batched_c2f on the rounds scheduler."""
        from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f

        return render_batched_c2f(self.params, self.dcfg, latents, origins, dirs,
                                  (self.img, self.img), self.march,
                                  **{**self._batched_kw(), **extra})

    def camera(self, K, R, T):
        from dist_renderer_tpu_torch.ops.camera import Camera

        return Camera(K=K, R=R, T=T)

    @torch.no_grad()
    def render_frame(self, latent, camera):
        """The served entry: render(), as the port's server calls it."""
        from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
        from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render

        if self._factory is None:
            proxy = self.proxy or (None, None)
            self._sdf_fn = make_precise_sdf(self.params, self.dcfg)
            self._factory = make_march_factory(self.params, self.dcfg, self.render_cfg,
                                               march_params=proxy[0], march_dcfg=proxy[1])
        return render(self._sdf_fn, latent, camera, self.render_cfg, self._factory)

    @torch.no_grad()
    def frame_trace_work(self, latent, camera) -> dict:
        """Ray-steps per network of one served frame, from two untimed
        passes of render_batched_c2f with the arguments render()'s
        trace_frame gives it (one with telemetry for the pyramid's
        ray-steps, and the proxy's trace alone to split the proxy's fine
        ray-steps from the verify stage's), and its hits."""
        from dist_renderer_tpu_torch.ops.camera import pixel_rays
        from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f

        m = self.march
        o, v = pixel_rays(camera, self.img, self.img)
        kw = dict(self._batched_kw(), scheduler=m.scheduler, queue_caps=m.queue_caps,
                  verify_mode=m.proxy_verify_mode, verify_band=m.proxy_verify_band,
                  verify_hits=("polish" if m.proxy_verify_hits == "polish-all"
                               else m.proxy_verify_hits),
                  verify_gen_caps=m.proxy_verify_caps_queue, return_steps=True,
                  return_anchor=True, return_last=True)
        args = (self.params, self.dcfg, latent[None], o[None, :1], v[None],
                (self.img, self.img), m)
        return self._split_steps(render_batched_c2f, args, kw)

    @torch.no_grad()
    def batch_work(self, latents, origins, dirs) -> dict:
        """Ray-steps per network of one batch, as frame_trace_work."""
        from dist_renderer_tpu_torch.ops.kernels.batched_march import render_batched_c2f

        args = (self.params, self.dcfg, latents, origins, dirs, (self.img, self.img),
                self.march)
        return self._split_steps(render_batched_c2f, args,
                                 dict(self._batched_kw(), return_steps=True))

    def _split_steps(self, fn, args, kw) -> dict:
        full, diag = fn(*args, with_diag=True, **kw)
        coarse = sum(int(t.sum()) for k, t in diag.items()
                     if k.startswith("coarse") and k.endswith("_ray_steps"))
        total = int(full.steps.sum())
        if self.proxy is None:
            return dict(coarse=coarse, fine=total, verify=0, hits=int(full.hit.sum()))
        proxy_only = fn(*args, proxy_verify=False, **kw)
        fine = int(proxy_only.steps.sum())
        return dict(coarse=coarse, fine=fine, verify=total - fine, hits=int(full.hit.sum()))

    def flops(self, steps: dict) -> dict:
        """2 x MACs of the counted ray-steps, per stage: the pyramid and the
        fine march step the march network, the verify stage and compose's
        recompute at each hit the decoder."""
        mm, md = self.march_macs, self.macs["decoder"]
        return dict(coarse=2.0 * mm * steps["coarse"], fine=2.0 * mm * steps["fine"],
                    verify=2.0 * md * steps["verify"], compose=2.0 * md * steps["hits"])
