"""Work arithmetic: multiply-adds per decoder evaluation from the
published layer sizes, and the card's published peaks.

The count follows the network's definition, not a kernel's padded tile
widths, so it stays put when an implementation changes: the latent is
folded into the biases of the layers that read it (it is constant over a
frame), so those layers cost (in - latent) x out multiply-adds.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 outside
# the tensor cores (operations a second); HBM3 (bytes a second)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def layer_dims(latent_size: int, hidden_dims: Sequence[int],
               latent_in: Iterable[int] = (), xyz_in_all: bool = False
               ) -> Tuple[Tuple[int, int], ...]:
    """(in, out) of each linear layer of a DeepSDF decoder (specs.json
    NetworkSpecs): the layer before a skip-concat layer shrinks its output
    so that concat([h, (latent, xyz)]) lands on the configured width."""
    latent_in = tuple(latent_in)
    dims = (latent_size + 3,) + tuple(hidden_dims) + (1,)
    n_layers = len(dims) - 1
    out = []
    for l in range(n_layers):
        d_in, d_out = dims[l], dims[l + 1]
        if (l + 1) in latent_in and (l + 1) < n_layers:
            d_out -= dims[0]
        if xyz_in_all and 0 < l < n_layers - 1 and l not in latent_in:
            d_in += 3
        if l in latent_in:
            d_in = dims[l]
        out.append((d_in, d_out))
    return tuple(out)


def folded_macs(latent_size: int, hidden_dims: Sequence[int],
                latent_in: Iterable[int] = (), xyz_in_all: bool = False) -> int:
    """Multiply-adds of one evaluation at one point, the latent folded
    into the biases of layer 0 and of each skip-concat layer."""
    latent_in = tuple(latent_in)
    total = 0
    for l, (d_in, d_out) in enumerate(layer_dims(latent_size, hidden_dims,
                                                 latent_in, xyz_in_all)):
        if l == 0 or l in latent_in:
            d_in -= latent_size
        total += d_in * d_out
    return total


def decoder_macs(spec: dict) -> int:
    """folded_macs of a configuration file's decoder entry."""
    return folded_macs(spec["latent_size"], spec["hidden_dims"],
                       spec.get("latent_in", ()), spec.get("xyz_in_all", False))


def bound_s(ops: float, nbytes: float = 0.0, peak: float = PEAK_BF16) -> float:
    """The least time the card could take for this work: the larger of its
    operations (2 a multiply-add) at ``peak`` and its bytes at the memory
    rate."""
    return max(ops / peak, nbytes / PEAK_BYTES)
