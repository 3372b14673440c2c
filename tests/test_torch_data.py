"""The data layer of the PyTorch port against the JAX package: the two
on-disk layouts written by either package's ``make_synthetic_data`` and
read by either package's loaders, the stdlib PNG reader against PIL,
``batch_iterator``'s order, and the three ``--data`` CLIs on the CPU.

One small decoder (24x4, latent 8, fitted to a sphere by the port)
exported as a DeepSDF experiment directory drives both writers and the
CLIs (``--experiment-dir``). Bars: arrays and cameras read from a layout
are equal bit for bit across the packages (the same files, the same
float32 parsing); the PNG reader equals PIL on every pixel. The CLIs'
bars are tests/test_tasks_data.py's for the JAX package.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from dist_renderer_tpu.data import datasets as jds
from dist_renderer_tpu.tasks import make_synthetic_data as jmake
from dist_renderer_tpu_torch.config import DecoderConfig, MarchConfig, RenderConfig
from dist_renderer_tpu_torch.data import datasets as tds
from dist_renderer_tpu_torch.models.analytic import latent_sphere_sdf, sphere_sdf
from dist_renderer_tpu_torch.models.checkpoint import save_deepsdf_experiment
from dist_renderer_tpu_torch.models.pretrain import fit_decoder_to_sdf
from dist_renderer_tpu_torch.tasks import (
    common, depth_completion, make_synthetic_data, multiview, pose_refine,
)
from dist_renderer_tpu_torch.utils.viz import png_array, png_bytes
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)

PIL = pytest.importorskip("PIL.Image")

IMG = 24
DRAW = ["--img", str(IMG), "--march-steps", "32"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"exp": the decoder's experiment dir, "jax": JAX's layouts, "port":
    the port's}, both written from that decoder at 24x24, 2 instances x 3
    views. The fallback-decoder cache is pointed away from the repo."""
    tmp = tmp_path_factory.mktemp("data")
    dcfg = DecoderConfig(latent_size=8, hidden_dims=(24,) * 4, latent_in=(2,))
    params, z0 = fit_decoder_to_sdf(lambda p: sphere_sdf(0.5)(None, p), dcfg, steps=150,
                                    batch=2048, device="cpu")
    exp = str(tmp / "exp")
    save_deepsdf_experiment(exp, params, dcfg, latents=z0[None])
    out = {"exp": exp, "jax": str(tmp / "jax"), "port": str(tmp / "port")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "REPO_ROOT", str(tmp))
        jmake.main(["--cpu", "--experiment-dir", exp] + DRAW
                   + ["--out", out["jax"], "--instances", "2", "--views", "3"])
        make_synthetic_data.main(["--cpu", "--experiment-dir", exp] + DRAW
                                 + ["--out", out["port"], "--instances", "2",
                                    "--views", "3"])
    return out


def _same_camera(a, b):
    for k in ("K", "R", "T"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      getattr(b, k).numpy() if isinstance(
                                          getattr(b, k), torch.Tensor)
                                      else np.asarray(getattr(b, k)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_depth_layout_reads_the_same_in_both_packages(roots, writer):
    """Either package's depth layout through both loaders: depth, valid,
    mask, latent and camera equal bit for bit, and a real shape in view."""
    root = os.path.join(roots[writer], "depth")
    t, j = tds.ShapeNetDepthDataset(root), jds.ShapeNetDepthDataset(root)
    assert t.instances == j.instances == ["inst0000", "inst0001"]
    for i in range(2):
        a, b = t[i], j[i]
        assert a.name == b.name
        for k in ("depth", "valid", "mask", "latent"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.depth.dtype == np.float32 and a.valid.dtype == bool
        assert isinstance(a.camera.R, torch.Tensor) and a.camera.R.dtype == torch.float32
        _same_camera(b.camera, a.camera)
        assert a.valid.sum() > 10 and a.mask.sum() > 10 and a.latent.shape == (8,)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multiview_layout_reads_the_same_in_both_packages(roots, writer):
    """Either package's PMO layout through both loaders (the port's PNG
    reader, JAX's PIL): images, masks and cameras equal bit for bit; hits
    carry the shaded normals, the background is black."""
    root = os.path.join(roots[writer], "multiview")
    t, j = tds.PMOMultiViewDataset(root), jds.PMOMultiViewDataset(root)
    assert len(t) == len(j) == 2
    a, b = t[1], j[1]
    assert a.images.shape == (3, IMG, IMG, 3) and a.masks.shape == (3, IMG, IMG)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.masks, b.masks)
    for ca, cb in zip(a.cameras, b.cameras):
        _same_camera(cb, ca)
    assert a.images[a.masks].mean() > 0.05 and a.images[~a.masks].max() == 0.0


def test_writers_agree_on_the_layout(roots):
    """Both writers put the same files, of the same types, in each
    instance; the port's masks are 8-bit gray PNGs as PIL writes them."""
    for sub in ("depth", "multiview"):
        for inst in ("inst0000", "inst0001"):
            names = [sorted(os.listdir(os.path.join(roots[w], sub, inst)))
                     for w in ("jax", "port")]
            assert names[0] == names[1]
    with PIL.open(os.path.join(roots["port"], "multiview", "inst0000", "mask00.png")) as im:
        assert im.mode == "L"
    with PIL.open(os.path.join(roots["port"], "multiview", "inst0000", "view00.png")) as im:
        assert im.mode == "RGB"


def test_png_reader_equals_pil_on_written_files(roots):
    """The stdlib reader against PIL on every PNG both writers made (PIL
    chooses its own row filters; the port's writer none)."""
    n = 0
    for w in ("jax", "port"):
        for dirpath, _, files in os.walk(os.path.join(roots[w], "multiview")):
            for f in files:
                if f.endswith(".png"):
                    path = os.path.join(dirpath, f)
                    with open(path, "rb") as fh, PIL.open(path) as im:
                        np.testing.assert_array_equal(png_array(fh.read()), np.asarray(im))
                    n += 1
    assert n == 24


def _png_filtered(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of img whose row y uses filter filters[y % len]: the
    encoder side of the five PNG filters, written out plainly."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        cur, up = rows[y], rows[y - 1] if y else np.zeros_like(rows[y])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        raw.append(f)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                             0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_all_filters_against_pil(channels, tmp_path):
    """Gray, gray + alpha, RGB and RGBA, every row filter (rows cycling
    through 0-4, and each alone), against PIL; the port's writer round
    trips; 16-bit and interlaced files are refused."""
    rng = np.random.default_rng(channels)
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:4] = np.arange(17, dtype=np.uint8).reshape((1, 17) + (1,) * (img.ndim - 2))
    for filters in ([0, 1, 2, 3, 4], [1], [2], [3], [4]):
        data = _png_filtered(img, filters)
        path = tmp_path / "f.png"
        path.write_bytes(data)
        with PIL.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        np.testing.assert_array_equal(png_array(data), img)
    if channels in (1, 3):
        np.testing.assert_array_equal(png_array(png_bytes(img)), img)
    bad = bytearray(_png_filtered(img, [0]))
    bad[24] = 16  # bit depth
    with pytest.raises(ValueError):
        png_array(bytes(bad))
    bad = bytearray(_png_filtered(img, [0]))
    bad[28] = 1  # interlace
    with pytest.raises(ValueError):
        png_array(bytes(bad))


def test_batch_iterator_gives_jax_batches(roots):
    """Same seed, same batches: over a list, and over both loaders of one
    layout (names compared); the partial last batch dropped."""
    for seed in (0, 5):
        ours = list(tds.batch_iterator(list(range(10)), 3, seed=seed))
        assert ours == list(jds.batch_iterator(list(range(10)), 3, seed=seed))
        assert len(ours) == 3
    assert list(tds.batch_iterator(list(range(5)), 2, shuffle=False)) == [[0, 1], [2, 3]]
    root = os.path.join(roots["jax"], "depth")
    t = [[o.name for o in b] for b in tds.batch_iterator(tds.ShapeNetDepthDataset(root), 1,
                                                         seed=1)]
    j = [[o.name for o in b] for b in jds.batch_iterator(jds.ShapeNetDepthDataset(root), 1,
                                                         seed=1)]
    assert t == j and len(t) == 2


def test_normalization_and_png_mask(tmp_path):
    """normalization.npz moves depth and camera into DeepSDF's normalized
    frame as JAX's loader does (depth equal; T within 1e-6: a 3x3 product
    in each library's order); a mask.png stands in for mask.npy."""
    inst = tmp_path / "chair001"
    inst.mkdir()
    depth = np.full((8, 8), 1.5, np.float32)
    depth[0, :3] = 0.0
    np.save(inst / "depth.npy", depth)
    mask = np.zeros((8, 8), np.uint8)
    mask[2:6, 1:7] = 255
    (inst / "mask.png").write_bytes(png_bytes(mask))
    c, s = np.cos(0.3), np.sin(0.3)
    cam = {"K": [[20.0, 0, 3.5], [0, 20.0, 3.5], [0, 0, 1]],
           "R": [[c, 0, s], [0, 1, 0], [-s, 0, c]], "T": [0.1, -0.2, 2.0]}
    (inst / "camera.json").write_text(json.dumps(cam))
    np.savez(inst / "normalization.npz", offset=np.array([0.05, -0.1, 0.2]), scale=0.8)
    a = tds.ShapeNetDepthDataset(str(tmp_path))[0]
    b = jds.ShapeNetDepthDataset(str(tmp_path))[0]
    np.testing.assert_array_equal(a.depth, b.depth)
    np.testing.assert_array_equal(a.valid, b.valid)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert a.valid.sum() == 61 and a.mask.sum() == 24 and a.latent is None
    np.testing.assert_allclose(a.camera.T.numpy(), np.asarray(b.camera.T), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a.camera.R.numpy(), np.asarray(b.camera.R))


def test_synthetic_dataset_and_missing_roots():
    """SyntheticShapeDataset's tuples, as tests/test_checkpoint_data.py
    checks JAX's; a missing root raises FileNotFoundError."""
    ds = tds.SyntheticShapeDataset(
        latent_sphere_sdf(), latents=np.array([[0.4], [0.5]], np.float32), img=16,
        n_views=4, render_cfg=RenderConfig(img_h=16, img_w=16,
                                           march=MarchConfig(max_steps=32)))
    obs = ds.depth_observation(0)
    assert obs.depth.shape == (16, 16) and obs.mask.sum() > 0
    assert isinstance(obs.depth, np.ndarray)
    mv = ds.multiview_observation(1)
    assert mv.images.shape == (4, 16, 16, 3) and mv.masks.shape == (4, 16, 16)
    assert len(mv.cameras) == 4
    assert mv.images[~mv.masks].max() == 0.0
    for cls in (tds.ShapeNetDepthDataset, tds.PMOMultiViewDataset):
        with pytest.raises(FileNotFoundError):
            cls("/nonexistent/root")


def _cli(roots):
    return ["--cpu", "--experiment-dir", roots["exp"]] + DRAW


def test_depth_completion_from_disk(roots, tmp_path, capsys):
    """tests/test_tasks_data.py's bar on the port, reading JAX's layout:
    the objective falls to under 0.7 of its peak after the shape
    appears (the zero latent renders little at step 0)."""
    res = depth_completion.main(_cli(roots) + [
        "--data", os.path.join(roots["jax"], "depth"), "--instance", "1",
        "--out", str(tmp_path / "out"), "--steps", "60", "--lr", "5e-2"])
    h = res.loss_history.numpy()
    assert np.isfinite(h).all() and h[-1] < 0.7 * h[1:].max()
    assert "observed-depth L1" in capsys.readouterr().out


def test_pose_refine_from_disk(roots, tmp_path):
    """tests/test_tasks_data.py's bar: the dataset camera recovered from
    an 8 degree, 0.05 perturbation within 4 degrees and 0.05, the
    instance's latent.npy freezing the shape."""
    res, rot_err, t_err = pose_refine.main(_cli(roots) + [
        "--data", os.path.join(roots["jax"], "depth"), "--instance", "0",
        "--out", str(tmp_path / "out"), "--steps", "120", "--lr", "3e-2",
        "--rot-err-deg", "8.0", "--trans-err", "0.05"])
    assert np.isfinite(res.loss_history.numpy()).all()
    assert rot_err < 4.0, rot_err
    assert t_err < 0.05, t_err


def test_multiview_from_disk(roots, tmp_path):
    """tests/test_tasks_data.py's bar, reading the port's layout: 15 steps
    never end above the first loss; no latent error is claimed."""
    res = multiview.main(_cli(roots) + [
        "--data", os.path.join(roots["port"], "multiview"),
        "--out", str(tmp_path / "out"), "--steps", "15", "--lr", "1e-2"])
    h = res.loss_history.numpy()
    assert np.isfinite(h).all() and h.min() <= h[0]
    with open(tmp_path / "out" / "summary.json") as f:
        summary = json.load(f)
    assert "latent_err" not in summary and 0.0 <= summary["mask_iou"] <= 1.0
