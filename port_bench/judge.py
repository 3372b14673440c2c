"""The comparison that decides ``correct``: each sampled answer of the
window against the plain reference (``reference/plain.py``) on the same
inputs.

Numbers, one set per answer (a frame of a batch, or a served request):

- ``hit_mismatch``: rays the reference is sure of (a sure hit crosses
  the surface, a sure miss stays clear of it) that the answer classes
  the other way, over the reference's sure hits;
- ``residual_p99``: the 99th percentile, over the answer's hits on
  rays the reference finds crossing the surface, of |SDF| of the full
  decoder in float32 at the answered point (origin + depth x
  direction): how far off the surface a hit lies;
- ``normal_p50_deg`` (answers with normals): the median over the same
  hits of the angle between the answered normal and the
  float32 decoder's gradient at the answered point.

Grazing rays (neither a sure hit nor a sure miss) are left out of all
three: whether such a ray hits depends on the march's step rule, and
where it does, the point compose moves it to is not defined by a
crossing.

Each number has its limit in ``limits/<cell>.json``; an answer fails
when a number is above its limit or not finite. ``control_answer`` is
the comparison's control: the reference itself, marched and composed in
float8, put in the program's place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from port_bench.reference.plain import Decoder, fp8, fp32, ray_slope, sphere_trace


def _quantile(x: torch.Tensor, q: float) -> float:
    if x.numel() == 0:
        return 0.0
    x = x.double()
    if not bool(torch.isfinite(x).all()):
        return float("nan")
    return float(torch.quantile(x, q))


def _trace(dec: Decoder, folded, o, v, opts: dict, quant=fp32, polish: int = 0):
    return sphere_trace(
        lambda p: dec.sdf(folded, p, quant), o, v, float(opts["eps"]),
        radius=float(opts.get("radius", 1.0)), max_steps=int(opts["max_steps"]),
        probe_h=float(opts["probe_h"]), probe_k=int(opts["probe_k"]),
        tau=float(opts["tau"]), polish=polish, slope=ray_slope(dec, folded, quant))


@torch.no_grad()
def numbers(dec: Decoder, latent: torch.Tensor, o: torch.Tensor, v: torch.Tensor,
            answer: Dict[str, torch.Tensor], opts: dict) -> Dict[str, float]:
    """The answer's numbers. answer: depth [n], hit [n] and optionally
    normal [n, 3], for rays o [1, 3] + t v [n, 3]."""
    folded = dec.fold(latent)
    ref = _trace(dec, folded, o, v, opts)
    hit = answer["hit"].reshape(-1).to(torch.bool)
    depth = answer["depth"].reshape(-1).to(torch.float32)
    sure = int(ref["sure_hit"].sum())
    wrong = int((ref["sure_hit"] & ~hit).sum()) + int((ref["sure_miss"] & hit).sum())
    idx = (hit & ref["sure_hit"]).nonzero().squeeze(1)
    p = o.expand(v.shape[0], 3)[idx] + depth[idx, None] * v[idx]
    out = {"hit_mismatch": wrong / max(sure, 1),
           "residual_p99": _quantile(dec.sdf(folded, p).abs(), 0.99)}
    if answer.get("normal") is not None:
        n_ans = answer["normal"].reshape(-1, 3)[idx].to(torch.float32)
        cos = (n_ans * dec.normals(folded, p)).sum(-1).clamp(-1.0, 1.0)
        out["normal_p50_deg"] = _quantile(torch.rad2deg(torch.arccos(cos)), 0.5)
    return out


def failed(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return any(not (math.isfinite(nums[k]) and nums[k] <= limits[k]) for k in limits)


@torch.no_grad()
def control_answer(dec: Decoder, latent: torch.Tensor, o: torch.Tensor,
                   v: torch.Tensor, opts: dict, normals: bool,
                   polish: int = 0) -> Dict[str, Optional[torch.Tensor]]:
    """The reference marched (and with ``polish`` Newton steps composed)
    in float8 e4m3: an answer in the program's place."""
    folded = dec.fold(latent)
    tr = _trace(dec, folded, o, v, opts, quant=fp8, polish=polish)
    ans = {"depth": torch.nan_to_num(tr["depth"]), "hit": tr["hit"], "normal": None}
    if normals:
        idx = tr["hit"].nonzero().squeeze(1)
        nrm = torch.zeros_like(v)
        p = o.expand(v.shape[0], 3)[idx] + ans["depth"][idx, None] * v[idx]
        nrm[idx] = dec.normals(folded, p, fp8)
        ans["normal"] = nrm
    return ans
