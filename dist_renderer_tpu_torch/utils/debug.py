"""Numerical debugging helpers (the JAX package's ``utils/debug.py``):
NaN tracking and a check of a render's outputs.

The JAX package's third helper, ``pallas_interpret``, forced every Pallas
kernel into interpret mode. The port has no global switch for that: each
kernel wrapper takes ``use_kernel=False`` (``make_march_factory``,
``make_precise_sdf``, ``SDFRenderer``) to run its plain PyTorch version,
per call. A global "run the plain versions" switch would be a fallback
from the kernels, which the port does not have.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _is_float(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.numel() > 0 and (
        t.is_floating_point() or t.is_complex())


class _RaiseOnNaN(TorchDispatchMode):
    """Raise FloatingPointError at the first op whose output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if _is_float(t) and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False) -> Iterator[None]:
    """Within the scope, with ``nans``: raise at the first op that makes a
    NaN (as ``jax_debug_nans`` does), forward and, through autograd's
    anomaly detection, backward; without it, anomaly detection is off.
    Everything is restored on exit. ``disable_jit`` is kept for the JAX
    signature and does nothing: eager PyTorch has no jit to disable."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.autograd.set_detect_anomaly(nans))
        if nans:
            stack.enter_context(_RaiseOnNaN())
        yield


class CheckError:
    """What ``checkify_render``'s check found: ``get()`` gives the message,
    or None when every output is finite; ``throw()`` raises it."""

    def __init__(self, message: Optional[str] = None):
        self._message = message

    def get(self) -> Optional[str]:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)


def checkify_render(render_fn: Callable) -> Callable:
    """Wrap a render function: the wrapped one returns (err, out), err a
    CheckError naming the outputs that hold NaN or inf values."""

    def checked(*args, **kwargs):
        out = render_fn(*args, **kwargs)
        leaves = tree_flatten(out)[0]
        bad = [i for i, t in enumerate(leaves)
               if _is_float(t) and not bool(torch.isfinite(t).all())]
        msg = (f"non-finite values in output leaves {bad} of {len(leaves)}"
               if bad else None)
        return CheckError(msg), out

    return checked
