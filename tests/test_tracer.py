"""Tracer-level properties: backend parity, determinism, ray accounting
(SURVEY.md §4 Property + Golden rows). The two device tracer modes and the
NumPy oracle are mutual oracles."""

import numpy as np
import pytest

from tpurt import config, cpu_ref, film as film_mod, render, scene as scene_mod

CFG = config.RenderConfig(width=48, height=36, spp=4, max_depth=6,
                          scene="spheres_plane", mode="mega", seed=9)


@pytest.fixture(scope="module")
def sp_scene():
    return config.build_scene(CFG)


@pytest.fixture(scope="module")
def cornell_scene():
    return config.build_scene(CFG.replace(scene="cornell"))


def test_mega_matches_oracle(sp_scene):
    scene, cam = sp_scene
    f_dev, s_dev = render.render(CFG, scene, cam)
    f_ref, s_ref = cpu_ref.render(CFG, scene, cam)
    assert s_dev["rays"] == s_ref["rays"]  # identical RNG => identical paths
    assert film_mod.rmse(f_dev, f_ref) < 1e-4


def test_wavefront_matches_mega(sp_scene):
    scene, cam = sp_scene
    f_mega, s_mega = render.render(CFG, scene, cam)
    f_wave, s_wave = render.render(CFG.replace(mode="wavefront"), scene, cam)
    assert s_mega["rays"] == s_wave["rays"]
    assert film_mod.rmse(f_mega, f_wave) < 1e-5


def test_cornell_all_materials(cornell_scene):
    scene, cam = cornell_scene
    cfg = CFG.replace(scene="cornell")
    f_dev, s_dev = render.render(cfg, scene, cam)
    f_ref, s_ref = cpu_ref.render(cfg, scene, cam)
    assert s_dev["rays"] == s_ref["rays"]
    assert film_mod.rmse(f_dev, f_ref) < 1e-4
    assert f_dev.mean() > 0.01  # the light actually illuminates the box


def test_russian_roulette_parity(sp_scene):
    scene, cam = sp_scene
    cfg = CFG.replace(rr_start=2, max_depth=10)
    f_dev, s_dev = render.render(cfg, scene, cam)
    f_ref, s_ref = cpu_ref.render(cfg, scene, cam)
    assert s_dev["rays"] == s_ref["rays"]
    assert film_mod.rmse(f_dev, f_ref) < 1e-4
    # RR must actually kill rays vs the no-RR run
    _, s_norr = render.render(CFG.replace(max_depth=10), scene, cam)
    assert s_dev["rays"] < s_norr["rays"]


def test_same_seed_bit_identical(sp_scene):
    scene, cam = sp_scene
    f1, _ = render.render(CFG, scene, cam)
    f2, _ = render.render(CFG, scene, cam)
    assert np.array_equal(f1, f2)


def test_different_seed_differs(sp_scene):
    scene, cam = sp_scene
    f1, _ = render.render(CFG, scene, cam)
    f2, _ = render.render(CFG.replace(seed=10), scene, cam)
    assert not np.array_equal(f1, f2)


def test_chunking_invariance(sp_scene):
    """Decomposition must not change the image (counter-based RNG)."""
    scene, cam = sp_scene
    f_one, _ = render.render(CFG, scene, cam)
    tiny = CFG.replace(ray_batch=512)  # forces pixel blocks + spp chunks
    f_chunked, _ = render.render(tiny, scene, cam)
    assert film_mod.rmse(f_one, f_chunked) < 1e-6


def test_primary_mode(sp_scene):
    scene, cam = sp_scene
    cfg = CFG.replace(mode="primary", spp=1)
    f_dev, s_dev = render.render(cfg, scene, cam)
    f_ref, _ = cpu_ref.render(cfg, scene, cam)
    assert s_dev["rays"] == cfg.width * cfg.height
    assert film_mod.rmse(f_dev, f_ref) < 1e-4


def test_mesh_scene_bvh_vs_brute(micro_mesh):
    v, f = micro_mesh
    cfg = CFG.replace(max_depth=5)
    sc_b, cam = scene_mod.mesh_scene(cfg.aspect, v, f, use_bvh=True)
    sc_n, _ = scene_mod.mesh_scene(cfg.aspect, v, f, use_bvh=False)
    f_b, s_b = render.render(cfg, sc_b, cam)
    f_n, s_n = render.render(cfg, sc_n, cam)
    assert s_b["rays"] == s_n["rays"]
    assert film_mod.rmse(f_b, f_n) < 1e-6
    # and the oracle agrees through the BVH path too
    f_ref, s_ref = cpu_ref.render(cfg, sc_b, cam)
    assert s_ref["rays"] == s_b["rays"]
    assert film_mod.rmse(f_b, f_ref) < 1e-4


def test_nan_free(cornell_scene):
    scene, cam = cornell_scene
    cfg = CFG.replace(scene="cornell", spp=8, max_depth=12)
    f_dev, _ = render.render(cfg, scene, cam)
    assert np.isfinite(f_dev).all()


def test_effective_ray_batch_scopes_the_512k_default():
    """The 512k batch is a BVH-traversal optimization (per-batch link
    amortization); brute-force bounce paths cap at BRUTE_RAY_BATCH and
    primary mode keeps the full batch."""
    from tpurt import config, render

    cfg_brute = config.RenderConfig(width=8, height=8, spp=1,
                                    scene="cornell", mode="mega")
    scene_brute, _ = config.build_scene(cfg_brute)
    assert scene_brute.pk_nodes is None
    assert (render.effective_ray_batch(cfg_brute, scene_brute)
            == render.BRUTE_RAY_BATCH)
    # primary mode on the same no-BVH scene keeps the configured batch
    cfg_prim = cfg_brute.replace(mode="primary")
    assert (render.effective_ray_batch(cfg_prim, scene_brute)
            == cfg_prim.ray_batch)
    # BVH scenes keep the configured batch in every mode
    cfg_bvh = config.RenderConfig(width=8, height=8, spp=1, scene="blob",
                                  mesh_subdiv=2, mode="mega")
    scene_bvh, _ = config.build_scene(cfg_bvh)
    assert scene_bvh.pk_nodes is not None
    assert render.effective_ray_batch(cfg_bvh, scene_bvh) == cfg_bvh.ray_batch
    # an explicitly SMALLER ray_batch is never raised by the cap
    cfg_small = cfg_brute.replace(ray_batch=1 << 12)
    assert render.effective_ray_batch(cfg_small, scene_brute) == 1 << 12


def test_bounce_stage_caps_override_is_image_invariant(sp_scene):
    """The BOUNCE_STAGE_CAPS override must be a pure reschedule: any ladder shape produces bit-identical
    radiance (stage compaction only changes WHERE rows live, never
    which rays bounce or in what RNG order)."""
    from tpurt import trace

    scene, cam = sp_scene
    f_base, s_base = render.render(CFG, scene, cam)
    old = trace.BOUNCE_STAGE_CAPS
    trace.BOUNCE_STAGE_CAPS = (2, 1)   # aggressive 2-stage ladder
    try:
        f_alt, s_alt = render.render(CFG, scene, cam)
    finally:
        trace.BOUNCE_STAGE_CAPS = old
    assert s_base["rays"] == s_alt["rays"]
    assert np.array_equal(np.asarray(f_base), np.asarray(f_alt))


def test_trace_static_returns_original_queue_order(sp_scene):
    """trace_static's contract (the shard_map wavefront body): radiance
    comes back in the INPUT queue order, so the caller's sample-axis
    reduction replaces the former per-ray segment_sum. Folding its
    output by the ORIGINAL pix ids must reproduce trace_chunk's film."""
    import jax.numpy as jnp

    from tpurt import camera as camera_mod, rng, wavefront

    scene, cam = sp_scene
    n = 512   # 4 packets, packet-aligned
    pix = jnp.arange(n, dtype=jnp.int32)
    keys = rng.make_streams(jnp.uint32(7), pix, jnp.zeros(n, jnp.int32))
    jit2 = rng.camera_draws(keys)
    o, d = camera_mod.generate_rays(cam, CFG.width, CFG.height, pix, jit2)
    q = wavefront.make_queue(o, d, pix, keys)

    npix = CFG.width * CFG.height
    film_a = jnp.zeros((npix, 3), jnp.float32)
    film_a, rays_a = wavefront.trace_chunk(scene, film_a, q, 6, None)

    rad, rays_b = wavefront.trace_static(scene, q, 6, None)
    film_b = jnp.zeros((npix, 3), jnp.float32).at[pix].add(rad)
    assert rays_a == int(rays_b)
    assert np.allclose(np.asarray(film_a), np.asarray(film_b), atol=1e-5)
