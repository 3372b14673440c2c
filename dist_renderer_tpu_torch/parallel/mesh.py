"""Device meshes over a torch.distributed process group.

Counterpart of the JAX package's ``parallel/mesh.py``. The axes:

  - "latents": independent shapes or frames (data parallel: no
    collectives during the march);
  - "rays": the pixels of a frame (the march needs no communication per
    ray; the gradient of a latent shared by several ray shards sums over
    this axis).

JAX runs one controller over many devices. Here each rank is a process
that holds its own slice, so the JAX package's shardings become functions
that return this rank's slice (``ray_sharding``, ``latent_sharding``) or
the whole tensor (``replicated``), and outputs meet in ``gather``.
``run_ranks`` spawns n ranks on a file rendezvous: the port's stand-in for
the JAX package's fake-device CPU mesh, used by the tests and
``parallel/dryrun.py``.

The backend is always the caller's choice: "nccl" when every rank owns a
card (rank r on cuda:r); "gloo" on the CPU, or with ranks sharing cards
(rank r on cuda:(r % cards)), the only choice with more ranks than cards,
since NCCL refuses two ranks on one GPU. Asked for NCCL with more ranks
than cards, ``check_backend`` raises; it never switches backend. Gloo
moves host tensors, so under gloo a CUDA tensor's collective goes through
the host, explicitly (``gather``, ``all_reduce``).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(axes: Sequence[str] = ("latents", "rays"),
              shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh over the initialised process group, ranks laid out in
    row-major order. With shape=None every rank goes on the LAST axis
    (rays), the right default for single-frame rendering, and 1 on the
    others. A shape whose product is not the world size raises
    ValueError."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(run_ranks, or torchrun and init_process_group)")
    n = dist.get_world_size()
    if shape is None:
        shape = [1] * (len(axes) - 1) + [n]
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name the axes {tuple(axes)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along the mesh axis."""
    return mesh.get_local_rank(axis)


def _shard(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    k = axis_size(mesh, axis)
    if x.shape[dim] % k:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over the {k} shards of mesh axis {axis!r}")
    m = x.shape[dim] // k
    return x.narrow(dim, axis_index(mesh, axis) * m, m)


def ray_sharding(x: torch.Tensor, mesh: DeviceMesh, axis: str = "rays",
                 dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of a ray-major tensor: dim split over
    ``axis`` (its size must divide)."""
    return _shard(x, mesh, axis, dim)


def latent_sharding(x: torch.Tensor, mesh: DeviceMesh, axis: str = "latents",
                    dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of a latent- or frame-major tensor."""
    return _shard(x, mesh, axis, dim)


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank holds the whole tensor."""
    del mesh
    return x


def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """all_gather of every rank's ``t`` (equal shapes) over the mesh axis,
    concatenated on ``dim`` in axis order; on t's device. No gradient."""
    group = mesh.get_group(axis)
    k = dist.get_world_size(group)
    if k == 1:
        return t
    x = t.detach()
    x = (x.cpu() if _through_host(t, group) else x).contiguous()
    flag = x.dtype == torch.bool  # sent as bytes
    if flag:
        x = x.to(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(k)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    return (out.bool() if flag else out).to(t.device)


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Every rank's ``t`` reduced over ``group`` (default: the world) by
    ``op`` (default: the sum), out of place, on t's device."""
    x = t.detach()
    x = (x.cpu() if _through_host(t, group) else x).clone()
    dist.all_reduce(x, op=op, group=group)
    return x.to(t.device)


def check_backend(n: int, backend: str, device: str, n_cards: int) -> None:
    """Raise unless ``n`` ranks can run on ``backend`` and ``device``
    ("cpu" or "cuda") with ``n_cards`` CUDA cards."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if device == "cpu":
        if backend != "gloo":
            raise ValueError("NCCL runs on CUDA cards only: the CPU takes gloo")
        return
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if n_cards == 0:
        raise RuntimeError("no CUDA card is available: pass device='cpu' to run "
                           "the ranks on the CPU")
    if backend == "nccl" and n > n_cards:
        raise ValueError(
            f"NCCL needs a card per rank: {n} ranks on {n_cards} card(s) would put "
            "two ranks on one card, which NCCL refuses; pass backend='gloo' to "
            "let the ranks share cards")


def rank_device(rank: int, backend: str, device: str) -> torch.device:
    """The device of rank ``rank``: the CPU, cuda:rank under NCCL, or
    cuda:(rank % cards) for ranks sharing cards under gloo."""
    if device == "cpu":
        return torch.device("cpu")
    n_cards = torch.cuda.device_count()
    return torch.device("cuda", rank if backend == "nccl" else rank % n_cards)


def to_device(x, dev):
    """x with every tensor in it (through tuples, named tuples, lists and
    dicts, and any object with a ``to``) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(a, dev) for a in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(a, dev) for a in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if hasattr(x, "to") and not isinstance(x, type):
        return x.to(dev)
    return x


def _rank_main(rank, n, backend, device, init_file, out_file, timeout, fn, args):
    from dist_renderer_tpu_torch.models.decoder import set_fp32_matmul

    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        set_fp32_matmul()
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, init_method="file://" + init_file,
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=timeout))
    try:
        res = fn(*args)
        if rank == 0:
            with open(out_file, "wb") as f:
                pickle.dump(to_device(res, "cpu"), f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, backend: str, device: str,
              timeout: float = 600.0):
    """Run ``fn(*args)`` on ``n`` spawned ranks of one process group and
    return rank 0's result, its tensors on the CPU.

    ``fn`` must be importable at module level (the ranks are spawned,
    which CUDA requires, and get it by reference). Each rank sets its
    device (``rank_device``) before it calls fn: the CPU with its share
    of the cores, or its card as the current CUDA device. The ranks meet
    on a file rendezvous in a temporary directory, so concurrent groups
    never contend for a port. A rank that raises fails the whole run; a
    collective that waits longer than ``timeout`` seconds raises. The
    arguments reach the ranks through the host (``to_device(args,
    "cpu")``); each rank moves what it needs to its device."""
    check_backend(n, backend, device,
                  torch.cuda.device_count() if device == "cuda" else 0)
    args = to_device(args, "cpu")
    with tempfile.TemporaryDirectory(prefix="drt_ranks_") as tmp:
        out_file = os.path.join(tmp, "rank0.pkl")
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=n, join=True, start_method="spawn",
            args=(n, backend, device, os.path.join(tmp, "rendezvous"),
                  out_file, timeout, fn, args))
        with open(out_file, "rb") as f:
            return pickle.load(f)
