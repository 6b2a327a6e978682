"""Numerical-hygiene checks (SURVEY.md §5 "Race detection / sanitizers"):
the JAX analog of running the reference under sanitizers — jax_debug_nans
over a render that exercises every material, plus the dielectric edge
cases that classically produce fireflies/NaNs (SURVEY.md §7 hard part 5)."""

import jax
import numpy as np

from tpurt import config, render, film as film_mod


def test_render_under_debug_nans():
    """Any NaN produced anywhere in the compiled render raises here."""
    cfg = config.RenderConfig(width=32, height=32, spp=4, max_depth=8,
                              scene="cornell", mode="mega", seed=3)
    scene, cam = config.build_scene(cfg)
    with jax.debug_nans(True):
        film, _ = render.render(cfg, scene, cam)
    assert np.isfinite(film).all()


def test_grazing_dielectric_rays_finite():
    """Rays aimed at a glass sphere's silhouette (grazing incidence, TIR
    boundary) must not produce NaN/Inf radiance."""
    import jax.numpy as jnp

    from tpurt import rng, trace

    cfg = config.RenderConfig(scene="spheres_plane", width=4, height=4)
    scene, cam = config.build_scene(cfg)
    scene = scene.device()

    # glass sphere at (2.2, 1, 0), r=1: aim a fan of rays at its rim
    n = 256
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    # target points on the silhouette circle as seen from +z
    tx = 2.2 + 0.99999 * np.cos(theta)
    ty = 1.0 + 0.99999 * np.sin(theta)
    o = np.tile(np.array([[2.2, 1.0, 8.0]], np.float32), (n, 1))
    d = np.stack([tx - o[:, 0], ty - o[:, 1], -8.0 * np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    keys = rng.make_streams(0, jnp.arange(n, dtype=jnp.int32),
                            jnp.zeros(n, jnp.int32))
    rad, _ = trace.trace(scene, jnp.asarray(o), jnp.asarray(d), keys, 10)
    assert np.isfinite(np.asarray(rad)).all()


def test_tonemap_cleans_hostile_input():
    hostile = np.array([[[np.inf, -np.inf, np.nan]]], np.float32)
    out = film_mod.tonemap(hostile)
    assert out.dtype == np.uint8
    assert (out == np.array([255, 0, 0], np.uint8)).all()
