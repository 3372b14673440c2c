"""eval/raycast.py and tasks/preprocess_shapenet.py on the port against
the JAX package's (tests/test_preprocess.py's cases on the port): OBJ
input, the numpy and native raycasters, mesh depth maps and DeepSDF's
normalization, and the preprocessing tool's files, read back by the
port's datasets in both layouts.

Bars: the numpy raycaster equals JAX's bit for bit (the same numpy code);
native against numpy as there (hits equal, 1e-4); the depth maps of a
unit-scale mesh within 1e-6 of JAX's (the packages' pixel rays differ in
the last bits), the preprocessed arrays (a mesh 3.1x larger, off
centre: ray lengths near 4) within relative 1e-5 (read: 2.9e-6); the
cameras' JSON within 1e-6, entry for entry; the PNGs equal pixel for
pixel (the port writes them with its stdlib writer, JAX with PIL)."""

import json
import os

import numpy as np
import pytest
import torch

from dist_renderer_tpu.eval import raycast as jrc
from dist_renderer_tpu.ops.camera import Camera as JCamera
from dist_renderer_tpu.tasks.preprocess_shapenet import preprocess_mesh as jpreprocess
from dist_renderer_tpu_torch.data.datasets import PMOMultiViewDataset, ShapeNetDepthDataset
from dist_renderer_tpu_torch.eval import raycast as rc
from dist_renderer_tpu_torch.eval.mesh import extract_mesh, save_obj
from dist_renderer_tpu_torch.models.analytic import sphere_sdf
from dist_renderer_tpu_torch.ops.camera import Camera
from dist_renderer_tpu_torch.tasks import preprocess_shapenet
from dist_renderer_tpu_torch.utils.viz import read_png
from test_torch_grad import one_thread  # noqa: F401 (autouse: torch on one thread)


@pytest.fixture(scope="module")
def sphere_mesh():
    sdf = sphere_sdf(0.6)
    verts, faces = extract_mesh(lambda p: sdf(None, p), resolution=48, device="cpu")
    assert len(faces) > 100
    return verts, faces


def _rays(n=200, seed=0):
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3).astype(np.float32) * 0.2
    origins[:, 2] -= 2.0
    dirs = -origins + rng.randn(n, 3).astype(np.float32) * 0.1
    return origins, (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)


def test_obj_roundtrip_and_jax_reader(tmp_path, sphere_mesh):
    verts, faces = sphere_mesh
    path = os.path.join(tmp_path, "m.obj")
    save_obj(path, verts, faces)
    v2, f2 = rc.load_obj(path)
    assert v2.dtype == np.float32 and f2.dtype == np.int64
    np.testing.assert_allclose(v2, verts, atol=1e-5)
    np.testing.assert_array_equal(f2, faces)
    jv, jf = jrc.load_obj(path)
    np.testing.assert_array_equal(v2, jv)
    np.testing.assert_array_equal(f2, jf)
    # polygons fan-triangulate; v/vt/vn and negative indices
    with open(path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1/1 2/2/2 3/3/3 4/4/4\nf -4 -3 -1\n")
    v3, f3 = rc.load_obj(path)
    np.testing.assert_array_equal(f3, [[0, 1, 2], [0, 2, 3], [0, 1, 3]])
    np.testing.assert_array_equal(f3, jrc.load_obj(path)[1])


def test_numpy_raycaster_equals_jax_and_native(sphere_mesh):
    from dist_renderer_tpu_torch.eval.native import raycast_depth_native

    verts, faces = sphere_mesh
    origins, dirs = _rays()
    ref = rc.raycast_depth_numpy(verts, faces, origins, dirs)
    np.testing.assert_array_equal(ref, jrc.raycast_depth_numpy(verts, faces, origins, dirs))
    nat = raycast_depth_native(verts, faces, origins, dirs)
    if nat is None:
        pytest.skip("native library unavailable")
    hit_r, hit_n = np.isfinite(ref), np.isfinite(nat)
    np.testing.assert_array_equal(hit_r, hit_n)
    np.testing.assert_allclose(nat[hit_n], ref[hit_r], atol=1e-4)
    assert hit_r.sum() > 50
    np.testing.assert_array_equal(rc.raycast_depth(verts, faces, origins, dirs), nat)
    np.testing.assert_array_equal(
        rc.raycast_depth(verts, faces, origins, dirs, use_native=False), ref)


def test_mesh_depth_and_normalization_match_jax(sphere_mesh):
    """render_mesh_depth under the port's camera against JAX's, and against
    the analytic sphere to grid-cell tolerance (tests/test_preprocess.py's
    bar); deepsdf_normalization equal to JAX's."""
    verts, faces = sphere_mesh
    img = 32
    kw = dict(focal=img * 1.2, img_hw=(img, img))
    depth, mask = rc.render_mesh_depth(verts, faces,
                                       Camera.looking_at((0.0, 0.0, -2.0), **kw), (img, img))
    jdepth, jmask = jrc.render_mesh_depth(verts, faces,
                                          JCamera.looking_at((0.0, 0.0, -2.0), **kw), (img, img))
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(depth, jdepth, rtol=0, atol=1e-6)
    assert mask.sum() > 50
    from dist_renderer_tpu_torch.models.analytic import analytic_sphere_depth
    from dist_renderer_tpu_torch.ops.camera import pixel_rays

    o, v = pixel_rays(Camera.looking_at((0.0, 0.0, -2.0), **kw), img, img)
    t_a = analytic_sphere_depth(o, v, 0.6).numpy().reshape(img, img)
    interior = (t_a > 0) & mask
    assert np.percentile(np.abs(depth - t_a)[interior], 95) < 2.0 / 47
    assert (mask != (t_a > 0)).mean() < 0.05
    raw = verts * 3.1 + np.array([0.5, -0.25, 0.8], np.float32)
    off, scale = rc.deepsdf_normalization(raw)
    joff, jscale = jrc.deepsdf_normalization(raw)
    np.testing.assert_array_equal(off, joff)
    assert scale == jscale
    assert np.linalg.norm((raw - off) * scale, axis=1).max() <= 1.0 / 1.02


def _cameras(path):
    """A camera.json or cameras.json as one flat array of K, R, T."""
    cams = json.loads(path.read_text())
    cams = cams if isinstance(cams, list) else [cams]
    assert all(sorted(c) == ["K", "R", "T"] for c in cams)
    return np.concatenate([np.ravel(c[k]) for c in cams for k in ("K", "R", "T")])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_preprocess_matches_jax_and_loads(tmp_path, sphere_mesh):
    """preprocess_mesh on one unnormalized OBJ in both packages (jittered
    cameras): the same files; arrays within relative 1e-5, the JSON
    within 1e-6, PNGs equal; the port's datasets read both layouts, and the loader's
    normalized depth equals a raycast of the normalized mesh from the
    loader's camera (tests/test_preprocess.py's round trip)."""
    verts, faces = sphere_mesh
    raw = verts * 3.1 + np.array([0.5, -0.25, 0.8], np.float32)
    obj = os.path.join(tmp_path, "meshes", "chair0.obj")
    save_obj(obj, raw, faces)
    kw = dict(views=2, img=24, camera_jitter=0.3)
    s = preprocess_shapenet.preprocess_mesh(obj, str(tmp_path / "port"), device="cpu", **kw)
    js = jpreprocess(obj, str(tmp_path / "jax"), **kw)
    assert s == js and len(s["instances"]) == 2
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 14
    for rel in files:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), rtol=1e-5, atol=1e-6,
                                       err_msg=rel)
        elif rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x) == sorted(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=rel)
        elif rel.endswith(".json"):
            np.testing.assert_allclose(_cameras(a), _cameras(b), rtol=0, atol=1e-6,
                                       err_msg=rel)
        else:
            np.testing.assert_array_equal(read_png(str(a)), read_png(str(b)), err_msg=rel)

    for root in (tmp_path / "port", tmp_path / "jax"):
        ds = ShapeNetDepthDataset(str(root / "depth"))
        assert len(ds) == 2
        obs = ds[0]
        assert obs.depth.shape == (24, 24) and obs.mask.sum() > 20
        off, scale = rc.deepsdf_normalization(raw)
        d_n, m_n = rc.render_mesh_depth((raw - off) * scale, faces, obs.camera, (24, 24))
        both = m_n & obs.valid
        assert both.sum() > 20
        np.testing.assert_allclose(obs.depth[both], d_n[both], rtol=1e-4, atol=1e-5)
        mv = PMOMultiViewDataset(str(root / "multiview"))[0]
        assert mv.images.shape == (2, 24, 24, 3) and mv.masks[0].sum() > 20
        assert np.all(mv.images[~mv.masks] == 0.0)


def test_preprocess_cli_needs_a_card_or_cpu(tmp_path, sphere_mesh, monkeypatch, capsys):
    """The CLI: --cpu runs on the CPU (every .obj of a directory), without
    it and without a card it raises; --no-depth writes the multiview
    layout only."""
    verts, faces = sphere_mesh
    save_obj(os.path.join(tmp_path, "m", "a.obj"), verts, faces)
    argv = ["--meshes", str(tmp_path / "m"), "--out", str(tmp_path / "out"), "--views", "1",
            "--img", "12", "--no-depth"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        preprocess_shapenet.main(argv)
    out = preprocess_shapenet.main(argv + ["--cpu"])
    assert out[0]["name"] == "a" and out[0]["instances"] == []
    assert "done: 1 meshes" in capsys.readouterr().out
    assert _files(tmp_path / "out") == ["multiview/a/cameras.json", "multiview/a/mask00.png",
                                        "multiview/a/normalization.npz",
                                        "multiview/a/view00.png"]
    with pytest.raises(RuntimeError, match="device="):
        preprocess_shapenet.preprocess_mesh(str(tmp_path / "m" / "a.obj"), str(tmp_path), 1, 8)
