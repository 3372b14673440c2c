"""The inverse-rendering optimizer harness: Adam over a tensor, or a
tuple or dict of tensors (latent code, pose vector, or both), with the
JAX package's staircase learning-rate decay, per-step loss history and
checkpoints to resume from.

Counterpart of the JAX package's ``utils/optim.py`` (optax Adam with
``exponential_decay(staircase=True)``). The step loop is a Python loop:
the JAX package's whole-loop ``lax.scan`` path saved a remote TPU's
per-step dispatch latency and has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from dist_renderer_tpu_torch.config import OptimConfig


class FitResult(NamedTuple):
    variables: Any                 # optimized variables, the input's structure
    loss_history: torch.Tensor     # [steps], the loss before each update
    metrics: Dict[str, Any]        # aux metrics from the last step


def _leaves(variables) -> Tuple[List[torch.Tensor], Callable]:
    """Flatten a tensor, tuple/list or dict of tensors; returns (leaves,
    rebuild)."""
    if isinstance(variables, torch.Tensor):
        return [variables], lambda xs: xs[0]
    if isinstance(variables, dict):
        keys = list(variables)
        return [variables[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(variables, (tuple, list)):
        kind = type(variables)
        return list(variables), lambda xs: kind(xs)
    raise TypeError("variables must be a tensor, or a tuple, list or dict "
                    f"of tensors (got {type(variables).__name__})")


def make_optimizer(params, cfg: OptimConfig):
    """Adam at cfg.lr, decayed by cfg.lr_decay_rate every
    cfg.lr_decay_steps updates (staircase):
    lr * rate ** floor(step / decay_steps). Returns (optimizer,
    scheduler); step the scheduler after each optimizer step."""
    opt = torch.optim.Adam(params, lr=cfg.lr)
    every = max(cfg.lr_decay_steps, 1)
    rate = cfg.lr_decay_rate
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: rate ** (step // every))
    return opt, sched


def fit(loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, Any]]],
        variables: Any, cfg: OptimConfig = OptimConfig(),
        checkpoint_dir: Optional[str] = None, log_every: int = 0,
        callback: Optional[Callable[[int, Any, float], None]] = None,
        carry_init: Any = None) -> FitResult:
    """Minimize ``loss_fn(variables) -> (loss, aux)`` with Adam for
    cfg.steps steps, starting from a copy of ``variables``.

    carry_init: optional state that is not differentiated. When given,
    ``loss_fn(variables, carry) -> (loss, aux)`` and aux must hold
    ``"carry"``, the next carry, threaded through the loop.
    callback(step, variables, loss) runs after each update.

    checkpoint_dir: where the variables, the optimizer's and the
    scheduler's state are saved every cfg.checkpoint_every steps
    (models/checkpoint.py's ``save_state``); a run that finds a saved
    step there resumes from it, runs steps start..cfg.steps - 1 and
    returns those steps' losses. The carry is not saved: on resume it
    restarts from carry_init, as in the JAX package."""
    leaves, rebuild = _leaves(variables)
    leaves = [torch.as_tensor(x).detach().clone().requires_grad_(True)
              for x in leaves]
    opt, sched = make_optimizer(leaves, cfg)
    start = 0
    if checkpoint_dir:
        from dist_renderer_tpu_torch.models.checkpoint import restore_state

        # on the CPU: Adam keeps its step counts there and moves the
        # moments to each variable's device as it loads them
        saved, start = restore_state(checkpoint_dir, None)
        if start:
            with torch.no_grad():
                for x, y in zip(leaves, saved["variables"]):
                    x.copy_(y)
            opt.load_state_dict(saved["optimizer"])
            sched.load_state_dict(saved["scheduler"])
    losses = []
    carry = carry_init
    aux: Dict[str, Any] = {}
    for step in range(start, cfg.steps):
        opt.zero_grad(set_to_none=True)
        v = rebuild(leaves)
        if carry_init is None:
            loss, aux = loss_fn(v)
        else:
            loss, aux = loss_fn(v, carry)
            aux = dict(aux)
            carry = aux.pop("carry")
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
        if log_every and (step % log_every == 0 or step == cfg.steps - 1):
            print(f"[fit] step {step:5d}  loss {float(loss.detach()):.6f}")
        if callback is not None:
            callback(step, rebuild([x.detach() for x in leaves]),
                     float(loss.detach()))
        if checkpoint_dir and cfg.checkpoint_every and (
                (step + 1) % cfg.checkpoint_every == 0):
            from dist_renderer_tpu_torch.models.checkpoint import save_state

            save_state(checkpoint_dir, {"variables": [x.detach() for x in leaves],
                                        "optimizer": opt.state_dict(),
                                        "scheduler": sched.state_dict()}, step + 1)
    history = torch.stack(losses) if losses else torch.zeros((0,))
    metrics = {k: (x.detach() if isinstance(x, torch.Tensor) else x)
               for k, x in aux.items()}
    return FitResult(variables=rebuild([x.detach() for x in leaves]),
                     loss_history=history, metrics=metrics)
