"""The checked-in micro-OBJ (SURVEY.md §4 fixtures): the full OBJ -> scene
-> BVH -> render path without needing a real asset."""

import pathlib

import numpy as np

from tpurt import config, cpu_ref, film as film_mod, render

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "micro.obj")


def test_obj_scene_renders_and_matches_oracle():
    cfg = config.RenderConfig(width=48, height=36, spp=3, max_depth=5,
                              scene=f"obj:{FIXTURE}", mode="mega", seed=1)
    scene, cam = config.build_scene(cfg)
    assert scene.tri_v0.shape[0] >= 80
    f_dev, s_dev = render.render(cfg, scene, cam)
    f_ref, s_ref = cpu_ref.render(cfg, scene, cam)
    assert s_dev["rays"] == s_ref["rays"]
    assert film_mod.rmse(f_dev, f_ref) < 1e-4
    assert np.isfinite(f_dev).all()


VN_FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
                 / "icosphere_vn.obj")


def test_obj_vn_parsing():
    from tpurt.io import obj as obj_io
    m = obj_io.load_mesh(VN_FIXTURE)
    assert m.has_normals
    assert m.normals.shape[0] == 42 and m.face_vn.shape == m.faces.shape
    # exact-sphere property of the fixture: vn index == v index
    assert np.array_equal(m.face_vn, m.faces)
    # load() keeps its 2-tuple contract
    v, f = obj_io.load(VN_FIXTURE)
    assert v.shape == (42, 3) and f.shape == (80, 3)


def test_smooth_normals_differ_from_flat_and_match_oracle():
    flat = config.RenderConfig(width=48, height=36, spp=2, max_depth=4,
                               scene=f"obj:{VN_FIXTURE}", mode="mega", seed=3)
    smooth = flat.replace(smooth=True)
    sc_f, cam = config.build_scene(flat)
    sc_s, _ = config.build_scene(smooth)
    assert sc_f.tri_shn is None and sc_s.tri_shn is not None

    f_flat, _ = render.render(flat, sc_f, cam)
    f_smooth, _ = render.render(smooth, sc_s, cam)
    # the icosphere's interpolated normals visibly smooth the faceting
    assert film_mod.rmse(f_flat, f_smooth) > 1e-3

    f_ref, _ = cpu_ref.render(smooth, sc_s, cam)
    assert film_mod.rmse(f_smooth, f_ref) < 1e-4


def test_smooth_without_vn_errors():
    import pytest

    cfg = config.RenderConfig(scene=f"obj:{FIXTURE}", smooth=True)
    with pytest.raises(ValueError, match="no vn"):
        config.build_scene(cfg)


def test_interpolated_normals_match_sphere_exactly():
    """On the unit icosphere with vn == vertex position, the interpolated
    normal at a hit is the normalized barycentric lerp of the corner
    positions — verify against an analytic probe through a face center."""
    from tpurt import trace
    import jax.numpy as jnp
    from tpurt.io import obj as obj_io
    from tpurt import scene as scene_mod

    m = obj_io.load_mesh(VN_FIXTURE)
    b = scene_mod.SceneBuilder(sky=True)
    mat = b.lambertian((0.5, 0.5, 0.5))
    b.mesh(m.verts, m.faces, mat, normals=m.normals, face_vn=m.face_vn)
    sc = b.build(use_bvh=True).device()

    # ray at the centroid of face 0, shot from outside along -centroid
    v = m.verts[m.faces[0]]
    cen = v.mean(axis=0)
    d = -cen / np.linalg.norm(cen)
    o = cen - 3.0 * d
    h = trace.intersect(sc, jnp.asarray([o], jnp.float32),
                        jnp.asarray([d], jnp.float32))
    assert bool(h.ok[0])
    expect = (m.normals[m.faces[0]].mean(axis=0))
    expect = expect / np.linalg.norm(expect)
    got = np.asarray(h.n[0])
    assert np.allclose(got, expect, atol=2e-3), (got, expect)


def test_obj_write_roundtrip_exact(tmp_path):
    """io.obj.write_mesh -> load_mesh is bit-exact for f64 meshes (the
    %.17g contract) and the scenes built from both mesh copies are
    byte-identical array for array — the equivalence the c3 bench
    asserts at contract scale (bench_render.build_scene_obj_checked)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "benchmarks"))
    from bench_render import build_scene_obj_checked

    from tpurt import config, meshgen
    from tpurt.io import obj as obj_io

    v, f = meshgen.blob(subdiv=2)
    p = tmp_path / "rt.obj"
    obj_io.write_mesh(str(p), v, f)
    m = obj_io.load_mesh(str(p))
    assert np.array_equal(m.verts, np.asarray(v, np.float64))
    assert np.array_equal(m.faces, np.asarray(f, np.int64))
    # the checked builder runs its own byte-identity asserts internally
    cfg = config.PRESETS["c3-mesh"].replace(mesh_subdiv=2)
    scene, cam = build_scene_obj_checked(cfg)
    assert scene.pk_nodes is not None
