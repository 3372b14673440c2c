"""Visualization: colorized depth, normal and silhouette maps, side-by-side
panels, PNG files and a per-iteration metrics log.

Counterpart of the JAX package's ``utils/viz.py``. It needs no image
library: PNGs are written with ``zlib`` + ``struct``, and depth is colored
by a small viridis-like numpy ramp (the JAX package reads matplotlib's
viridis, so the two packages' images differ in color, not in content).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

# viridis at 0, 1/4, 1/2, 3/4 and 1 (interpolated linearly between)
_RAMP = np.array([[0.267, 0.005, 0.329], [0.229, 0.322, 0.546],
                  [0.128, 0.567, 0.551], [0.369, 0.789, 0.383],
                  [0.993, 0.906, 0.144]])


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def colorize_depth(depth, mask=None, near: Optional[float] = None,
                   far: Optional[float] = None) -> np.ndarray:
    """Depth map -> uint8 RGB (near bright, far dark), background black."""
    d = _to_np(depth).astype(np.float64)
    m = _to_np(mask).astype(bool) if mask is not None else d > 0
    if m.any():
        lo = near if near is not None else d[m].min()
        hi = far if far is not None else d[m].max()
    else:
        lo, hi = 0.0, 1.0
    norm = np.zeros_like(d)
    if hi > lo:
        norm[m] = np.clip((d[m] - lo) / (hi - lo), 0, 1)
    t = (1.0 - norm) * (len(_RAMP) - 1)
    i = np.minimum(t.astype(np.int64), len(_RAMP) - 2)
    frac = (t - i)[..., None]
    rgb = ((_RAMP[i] * (1 - frac) + _RAMP[i + 1] * frac) * 255).astype(np.uint8)
    rgb[~m] = 0
    return rgb


def colorize_normal(normal, mask=None) -> np.ndarray:
    """Unit normals -> uint8 RGB with the usual (n+1)/2 encoding."""
    n = _to_np(normal)
    rgb = ((n + 1.0) * 0.5 * 255).clip(0, 255).astype(np.uint8)
    if mask is not None:
        rgb[~_to_np(mask).astype(bool)] = 0
    return rgb


def colorize_silhouette(min_sdf, scale: float = 20.0) -> np.ndarray:
    """Soft silhouette from the min-SDF margin: sigmoid(-scale * margin)."""
    s = 1.0 / (1.0 + np.exp(np.clip(scale * _to_np(min_sdf), -30, 30)))
    g = (s * 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def png_bytes(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> the bytes of an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_image(path: str, rgb: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def panel(images: Sequence[np.ndarray], pad: int = 4) -> np.ndarray:
    """Horizontal side-by-side panel (equal heights assumed)."""
    h = max(im.shape[0] for im in images)
    cols = []
    for im in images:
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        if im.shape[0] < h:
            im = np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)))
        cols.append(im)
        cols.append(np.zeros((h, pad, 3), np.uint8))
    return np.concatenate(cols[:-1], axis=1)


def render_panel(out, obs_depth=None) -> np.ndarray:
    """A depth | normal | silhouette (+ observation) panel of a render."""
    imgs = [colorize_depth(out.depth, out.mask),
            colorize_normal(out.normal, out.mask),
            colorize_silhouette(out.min_sdf)]
    if obs_depth is not None:
        imgs.append(colorize_depth(obs_depth))
    return panel(imgs)


def save_render_panel(path: str, out, obs_depth=None) -> None:
    """Save a render's panel: the per-iteration progress dump."""
    save_image(path, render_panel(out, obs_depth))


class MetricsLogger:
    """Per-iteration scalars -> CSV (+ TensorBoard when ``tensorboardX``
    is installed and a directory is given)."""

    def __init__(self, path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self._file = None
        self._keys = None
        self._tb = None
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                pass

    def log(self, step: int, **scalars) -> None:
        if self.path:
            if self._file is None:
                os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                            exist_ok=True)
                self._file = open(self.path, "w")
                self._keys = list(scalars.keys())
                self._file.write(",".join(["step"] + self._keys) + "\n")
            row = [str(step)] + [f"{float(scalars.get(k, float('nan'))):.6g}"
                                 for k in self._keys]
            self._file.write(",".join(row) + "\n")
            self._file.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
