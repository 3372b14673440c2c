"""Batched category-scale rendering: many latents x many views (config #5
of BASELINE.json: 1k latents x 16 views at 512^2), each (latent, view)
pair one frame.

    python -m dist_renderer_tpu_torch.tasks.batched_render --pallas --latents 16 --views 4 --img 128

--pallas streams the frames in chunks through the multi-frame
coarse-to-fine render (render_batched_c2f: the rounds scheduler on the
march kernels); without it every frame goes through render_rays. Under
--verify-hits polish or polish-all each chunk's hits are finalized against
the full decoder (finalize_hits_batched) before they are counted.

--scan (with --pallas --stream, and ignored otherwise, as in the JAX
package, whose --scan is one lax.map over the chunks in one jit) runs the
whole chunk loop as one program. On the card that is one CUDA graph of
every chunk's render and its on-device depth sum and hit count, captured
inside batched_march.host_free() (which takes every host read off the
batched render's path and keeps its bits) after an eager warm-up chunk
and before the timed region, which is one replay. With --cpu the same
host-free loop runs without a capture. On the card the line before the
result gives the graph's nodes and its capture and instantiate seconds:

    python -m dist_renderer_tpu_torch.tasks.batched_render --fast --pallas \\
        --proxy .bench_proxy.npz --stream --scan --latents 16 --views 4 --img 512 --chunk 16

Under a process group of several ranks (torchrun, which this module
joins with --dist-backend, or a group the caller initialised) each rank
renders its share of the latents, with no collectives in the march (under
--scan each rank captures its own graph); the hit counts, depth sums and
times are reduced to rank 0, which prints the result line:

    torchrun --nproc-per-node 4 -m dist_renderer_tpu_torch.tasks.batched_render \\
        --pallas --dist-backend gloo     # 4 ranks sharing one card
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Callable, List, NamedTuple

import torch
import torch.distributed as dist

from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
from dist_renderer_tpu_torch.models.folded import make_point_fn
from dist_renderer_tpu_torch.ops.camera import pixel_rays
from dist_renderer_tpu_torch.ops.kernels.batched_march import host_free
from dist_renderer_tpu_torch.ops.renderer import finalize_hits_batched, render_rays
from dist_renderer_tpu_torch.tasks.common import (
    add_common_args, load_task_decoder, make_render_cfg, ring_cameras,
    synchronize, task_device,
)


def latent_draws(n: int, size: int, device) -> torch.Tensor:
    """[n, size] standard-normal latent offsets from a fixed seed."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randn((n, size), generator=gen).to(device)


def pick_chunk(args, n_frames: int) -> int:
    """Frames per launch: a multiple of --views dividing latents*views, so
    frame i of every chunk pairs with view i % views (default: the largest
    such count <= 128)."""
    if args.chunk is not None:
        if args.chunk % args.views or n_frames % args.chunk:
            raise SystemExit(f"--chunk {args.chunk} must be a multiple of --views "
                             f"({args.views}) dividing latents*views ({n_frames})")
        return args.chunk
    chunk = min(128 - 128 % args.views if args.views <= 128 else args.views,
                n_frames)
    while chunk > args.views and n_frames % chunk:
        chunk -= args.views
    return chunk


class ChunkStream(NamedTuple):
    """The --pallas path's chunk loop: render_chunk(lat_f) -> (depth, hit),
    each [chunk, N], of one chunk's frames, and the chunks' latents (fixed
    views of one tensor)."""

    render_chunk: Callable
    chunks: List[torch.Tensor]
    device: torch.device


def stream_sums(cs: ChunkStream):
    """The fp64 depth sum over every chunk's hits and the hit count
    (int64), both summed on the device."""
    dsum = torch.zeros((), dtype=torch.float64, device=cs.device)
    hits = torch.zeros((), dtype=torch.int64, device=cs.device)
    for lat_c in cs.chunks:
        d, h = cs.render_chunk(lat_c)
        dsum += torch.where(h, d, 0.0).sum(dtype=torch.float64)
        hits += h.sum()
    return dsum, hits


def capture_scan(cs: ChunkStream):
    """--scan on the card: stream_sums as one CUDA graph, captured inside
    host_free() after one chunk's warm-up on a side stream. Returns (the
    instantiated graph; its (depth sum, hit count), which every replay
    rewrites; {nodes, capture_s, instantiate_s}). A call that cannot be
    captured raises: nothing runs eagerly in its place."""
    from dist_renderer_tpu_torch.utils.profiling import (
        capture, graph_nodes, warm_on_side_stream,
    )

    out = []
    with host_free():
        warm_on_side_stream(lambda: cs.render_chunk(cs.chunks[0]))
        t0 = time.perf_counter()
        graph = capture(lambda: out.append(stream_sums(cs)), 1, warm=False,
                        keep_graph=True)
        t1 = time.perf_counter()
        nodes = graph_nodes(graph)
        graph.instantiate()
        t2 = time.perf_counter()
    return graph, out[0], dict(nodes=nodes, capture_s=t1 - t0, instantiate_s=t2 - t1)


def join_torchrun(args) -> bool:
    """Under torchrun (WORLD_SIZE > 1) with no process group yet: put this
    rank on its device and initialise the group (env://) on
    --dist-backend (default: nccl on the card, gloo with --cpu; nccl with
    more ranks on a host than cards raises). Returns whether it did, so
    the caller destroys the group at the end."""
    from dist_renderer_tpu_torch.parallel.mesh import check_backend, rank_device

    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    device = "cpu" if args.cpu else "cuda"
    backend = args.dist_backend or ("gloo" if args.cpu else "nccl")
    check_backend(int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"])),
                  backend, device, torch.cuda.device_count() if not args.cpu else 0)
    if not args.cpu:
        torch.cuda.set_device(rank_device(int(os.environ["LOCAL_RANK"]), backend,
                                          device))
    dist.init_process_group(backend)
    return True


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(ap)
    ap.add_argument("--latents", type=int, default=16)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--latent-noise", type=float, default=0.05)
    ap.add_argument("--pallas", action="store_true",
                    help="the multi-frame coarse-to-fine path on the march "
                    "kernels (render_batched_c2f)")
    ap.add_argument("--stream", action="store_true",
                    help="with --pallas: reduce each chunk to a hit count and "
                    "a depth sum instead of keeping every depth map (1k "
                    "latents x 16 views at 512^2 is 16.8 GB of depth)")
    ap.add_argument("--scan", action="store_true",
                    help="with --pallas --stream: the whole chunk loop as one "
                    "program, on the card one CUDA graph captured before the "
                    "timed region and replayed once in it")
    ap.add_argument("--proxy", default=None,
                    help="a distilled proxy npz (models/proxy.py): the march "
                    "runs the proxy and a full-decoder verify stage re-derives "
                    "depth and hits")
    ap.add_argument("--chunk", type=int, default=None,
                    help="frames per launch on the --pallas path (a multiple "
                    "of --views dividing latents*views; default: the largest "
                    "such count <= 128)")
    ap.add_argument("--verify-hits", default="march",
                    choices=["march", "polish", "polish-all"],
                    help="with --proxy: the verify stage's treatment of proxy "
                    "hits (render_batched_c2f's verify_hits); the polish modes "
                    "finalize every chunk's hits against the full decoder")
    ap.add_argument("--dist-backend", choices=["gloo", "nccl"], default=None,
                    help="under torchrun: the process group's backend (default: "
                    "nccl on the card, gloo with --cpu; gloo lets ranks share "
                    "a card)")
    return ap.parse_args(argv)


def main(argv=None):
    """Prints (on rank 0) and returns the result line: Mrays/s and
    hit_frac. The returned dict also holds the exact ``hits`` and
    ``depth_sum`` (fp64) the line's hit_frac and mean depth round."""
    args = parse_args(argv)
    owns_group = join_torchrun(args)
    try:
        return _run(args)
    finally:
        if owns_group:
            dist.destroy_process_group()


class Scene(NamedTuple):
    """This rank's frames: the decoder, the config, every view's rays
    [views, N, 3] and this rank's latents."""

    params: dict
    dcfg: object
    cfg: object
    origins: torch.Tensor
    dirs: torch.Tensor
    latents: torch.Tensor
    device: torch.device


def scene(args) -> Scene:
    """The decoder, the ring cameras' rays and this rank's share of the
    latents (base latent + --latent-noise x latent_draws)."""
    dev = task_device(args)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if args.latents % world:
        raise SystemExit(f"--latents {args.latents} must divide over the {world} ranks")
    params, base_latent, dcfg = load_task_decoder(args)
    cams = ring_cameras(args.img, args.views, device=dev)
    rays = [pixel_rays(c, args.img, args.img) for c in cams]
    latents = base_latent[None] + args.latent_noise * latent_draws(
        args.latents, base_latent.shape[0], dev)
    # each rank renders its share of the latents (pure data parallel)
    per_rank = args.latents // world
    return Scene(params, dcfg, make_render_cfg(args),
                 torch.stack([r[0] for r in rays]), torch.stack([r[1] for r in rays]),
                 latents[rank * per_rank:(rank + 1) * per_rank], dev)


def chunk_stream(args, sc: Scene) -> ChunkStream:
    """The --pallas path's chunks (pick_chunk) and their render: the
    rounds scheduler on K1, and under --verify-hits polish or polish-all
    the full-decoder finalize."""
    from dist_renderer_tpu_torch.ops.kernels.batched_march import (
        pack_shared, render_batched_c2f,
    )

    params, dcfg, cfg, dev = sc.params, sc.dcfg, sc.cfg, sc.device
    n_frames = sc.latents.shape[0] * args.views
    chunk = pick_chunk(args, n_frames)
    reps = (chunk + args.views - 1) // args.views
    # ring cameras are pinholes: one origin per view
    o_chunk = sc.origins[:, :1].repeat(reps, 1, 1)[:chunk]
    v_chunk = sc.dirs.repeat(reps, 1, 1)[:chunk]
    m = cfg.march
    proxy = None
    pbo, pband = m.proxy_backoff, m.proxy_band
    if args.proxy:
        from dist_renderer_tpu_torch.models.proxy import (
            load_proxy_meta, load_proxy_npz, proxy_march_margins,
        )
        proxy = load_proxy_npz(args.proxy, dev)
        # the verify margins follow this proxy's measured error
        meta = load_proxy_meta(args.proxy)
        if meta:
            pbo, pband = proxy_march_margins(meta, m.convergence_eps)
    vh = args.verify_hits
    packed = (pack_shared(params, dcfg),
              None if proxy is None else pack_shared(*proxy))

    @torch.no_grad()
    def render_chunk(lat_f):
        st = render_batched_c2f(
            params, dcfg, lat_f, o_chunk, v_chunk, (args.img, args.img), m,
            shared_origin=True, proxy=proxy, proxy_backoff=pbo,
            proxy_band=pband, verify_mode=m.proxy_verify_mode,
            verify_band=m.proxy_verify_band, verify_hits=vh,
            verify_round_caps=m.proxy_verify_caps,
            verify_gen_caps=m.proxy_verify_caps_queue,
            proxy_block=m.proxy_block_width, packed=packed)
        if proxy is None or vh == "march":
            return st.depth, st.hit
        # the trace's confident proxy hits are unverified until here
        d, h, _ = finalize_hits_batched(
            params, dcfg, lat_f, o_chunk, v_chunk, st.depth, st.hit,
            st.min_sdf, convergence_eps=m.convergence_eps,
            background_depth=cfg.background_depth,
            ift_min_denom=cfg.grad.ift_min_denom,
            polish_iters=max(cfg.grad.polish_iters, 2),
            compact_frac=3 if vh == "polish-all" else 4, weak=st.weak)
        return d, h

    lat_frames = sc.latents.repeat_interleave(args.views, dim=0)
    return ChunkStream(render_chunk,
                       [lat_frames[s:s + chunk] for s in range(0, n_frames, chunk)], dev)


def _run(args):
    sc = scene(args)
    dev, cfg = sc.device, sc.cfg
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    extra = {}
    stream = args.pallas and args.stream
    # a warm-up on the card (the kernels build at their first launch); the
    # CPU has nothing to warm
    warm = dev.type == "cuda"

    if args.pallas:
        cs = chunk_stream(args, sc)
        extra["chunk_frames"] = cs.chunks[0].shape[0]
        if stream:
            # warm up on one chunk; the timed region streams every chunk
            if warm:
                cs.render_chunk(cs.chunks[0])
                synchronize(dev)
            if args.scan and warm:
                graph, (dsum_t, hits_t), info = capture_scan(cs)
                if rank == 0:
                    print(json.dumps({"scan_graph": info}))

                def render_batch():
                    graph.replay()
                    synchronize(dev)
                    return float(dsum_t), int(hits_t)
            else:
                def render_batch():
                    with host_free() if args.scan else contextlib.nullcontext():
                        dsum, hits = stream_sums(cs)
                    return float(dsum), int(hits)
        else:
            def render_batch():
                ds, hs = zip(*(cs.render_chunk(lat_c) for lat_c in cs.chunks))
                return torch.cat(ds), torch.cat(hs)
    else:
        params, dcfg = sc.params, sc.dcfg
        sdf_fn = make_precise_sdf(params, dcfg)

        @torch.no_grad()
        def render_batch():
            ds, hs = [], []
            for z in sc.latents:
                mf = make_point_fn(params, z, dcfg, cfg.dtype)
                for o, v in zip(sc.origins, sc.dirs):
                    out = render_rays(sdf_fn, z, o, v, cfg, mf)
                    ds.append(out.depth)
                    hs.append(out.mask)
            return torch.stack(ds), torch.stack(hs)

    if stream:
        t0 = time.perf_counter()
        dsum, hits = render_batch()
        dt = time.perf_counter() - t0
    else:
        if warm:
            render_batch()
            synchronize(dev)
        t0 = time.perf_counter()
        depth, mask = render_batch()
        synchronize(dev)
        dt = time.perf_counter() - t0
        hits = int(mask.sum())
        dsum = float(torch.where(mask, depth, 0.0).sum(dtype=torch.float64))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    if world > 1:
        from dist_renderer_tpu_torch.parallel.mesh import all_reduce

        # the group's collectives take card tensors under nccl
        red = dev if dist.get_backend() == "nccl" else torch.device("cpu")
        hits, dsum = all_reduce(torch.tensor([hits, dsum], dtype=torch.float64,
                                             device=red)).tolist()
        dt, peak = all_reduce(torch.tensor([dt, peak], dtype=torch.float64, device=red),
                              op=dist.ReduceOp.MAX).tolist()
        hits = int(hits)
    n_rays = args.latents * args.views * args.img * args.img
    extra.update(hit_frac=round(hits / n_rays, 4),
                 mean_hit_depth=round(dsum / max(hits, 1), 4))
    if dev.type == "cuda":
        extra["peak_hbm_gb"] = round(peak, 2)
    result = {"latents": args.latents, "views": args.views, "img": args.img,
              "total_rays": n_rays, "seconds": round(dt, 3),
              "Mrays_per_s": round(n_rays / dt / 1e6, 2), "devices": world, **extra}
    if rank == 0:
        print(json.dumps(result))
    return {**result, "hits": hits, "depth_sum": dsum}


if __name__ == "__main__":
    main()
