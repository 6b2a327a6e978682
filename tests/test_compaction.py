"""Wavefront compaction properties (SURVEY.md §4 Property row):
the per-bounce PACKET-granular compaction must preserve the multiset of
live rays and place every live ray inside the first `live_rows` rows
(whole 128-ray packets move; rays never leave their packet — measured
rationale in wavefront.step)."""

import jax.numpy as jnp
import numpy as np

from tpurt import config, render, rng, wavefront


def _queue(n=512, seed=3):
    cfg = config.RenderConfig(width=32, height=16, spp=1,
                              scene="spheres_plane")
    scene, cam = config.build_scene(cfg)
    scene = scene.device()
    pix = jnp.arange(n, dtype=jnp.int32)
    smp = jnp.zeros(n, jnp.int32)
    keys = rng.make_streams(seed, pix, smp)
    jit2 = rng.camera_draws(keys)
    o, d = render.camera_mod.generate_rays(cam, 32, 16, pix, jit2)
    return scene, wavefront.make_queue(o, d, pix, keys)


def _ray_sig(q, i):
    """Hashable identity of the ray in slot i."""
    return (float(q.o[i, 0]), float(q.o[i, 1]), float(q.o[i, 2]),
            float(q.d[i, 0]), float(q.d[i, 1]), float(q.d[i, 2]),
            int(q.pix[i]))


def test_step_sort_preserves_live_multiset_and_prefix():
    scene, q0 = _queue()
    q1, (live_rows, live_rays), cast = wavefront.step(
        scene, q0, jnp.int32(0), None)
    live_rows, live_rays = int(live_rows), int(live_rays)
    assert int(cast) == q0.o.shape[0]

    alive = np.asarray(q1.alive)
    # every live ray sits inside the first live_rows rows (whole packets);
    # rows beyond the bound are all dead
    assert live_rows % 128 == 0
    assert not alive[live_rows:].any()
    assert live_rays == alive.sum()
    # the bound is tight at packet granularity: each kept packet is live
    pk_live = alive[:live_rows].reshape(-1, 128).any(axis=1)
    assert pk_live.all()

    # the sorted queue is a permutation of the stepped rays: pixel ids are
    # unique here, so the multiset check reduces to uniqueness
    pix = np.asarray(q1.pix)
    assert len(set(pix.tolist())) == len(pix)  # uniqueness precondition


def test_shrink_then_finish_equals_full_queue():
    """Bucket shrinking must not change the image (rays are identified by
    their streams, not their slots)."""
    scene, q0 = _queue(n=1024)
    npix = 32 * 16
    film_a = jnp.zeros((npix, 3), jnp.float32)
    film_a, rays_a = wavefront.trace_chunk(scene, film_a, q0, 8, None)

    # force aggressive shrinking via a tiny MIN_BUCKET
    old = wavefront.MIN_BUCKET
    wavefront.MIN_BUCKET = 16
    try:
        film_b = jnp.zeros((npix, 3), jnp.float32)
        film_b, rays_b = wavefront.trace_chunk(scene, film_b, q0, 8, None)
    finally:
        wavefront.MIN_BUCKET = old
    assert rays_a == rays_b
    assert np.allclose(np.asarray(film_a), np.asarray(film_b), atol=1e-5)


def test_staged_chunk_matches_host_loop():
    """The one-dispatch staged bounce loop (trace_chunk_staged — the
    production wavefront path) must produce the host-loop trace_chunk's
    image, ray count, and a consistent per-bounce occupancy history."""
    scene, q0 = _queue(n=1024)
    npix = 32 * 16
    film_a = jnp.zeros((npix, 3), jnp.float32)
    film_a, rays_a = wavefront.trace_chunk(scene, film_a, q0, 8, None)

    # staged now returns radiance in the INPUT queue order; the caller
    # owns the film fold (render._wavefront_frame does a tile-order
    # slice-add — here the generic per-pixel accumulation)
    rad_b, rays_b, hist = wavefront.trace_chunk_staged(scene, q0, 8, None)
    film_b = jnp.zeros((npix, 3), jnp.float32).at[q0.pix].add(rad_b)
    assert rays_a == int(rays_b)
    assert np.allclose(np.asarray(film_a), np.asarray(film_b), atol=1e-5)
    hist = np.asarray(hist)
    assert hist.shape == (8,)
    # live counts decay monotonically (no RR resurrection); hist[b] is
    # the live count AFTER bounce b, so the rays-cast tally (live at
    # entry of each bounce) is capacity + all but the last entry
    assert (np.diff(hist) <= 0).all()
    assert int(rays_b) == q0.o.shape[0] + hist[:-1].sum()


def test_wavefront_ragged_block_matches_mega():
    """_render_wavefront pads the ragged last pixel block with born-dead
    rays; the padded chunks must not change the image or the ray count
    vs the megakernel on a frame whose pixel count is NOT a block
    multiple."""
    from tpurt import film, render as render_mod

    cfgw = config.RenderConfig(width=50, height=48, spp=2, seed=6,
                               scene="spheres_plane", mode="wavefront",
                               max_depth=6, rr_start=3, ray_batch=2048)
    cfgm = cfgw.replace(mode="mega")
    scene, cam = config.build_scene(cfgw)
    fw, sw = render_mod.render(cfgw, scene, cam)
    fm, sm = render_mod.render(cfgm, scene, cam)
    assert sw["rays"] == sm["rays"]
    assert float(film.rmse(fw, fm)) < 1e-6


def test_stage_caps_matches_round2_ladder():
    """stage_caps() must generate exactly the relative ladders it
    replaced:
    traversal p//2..p//64 floored at 8, bounce n//2..n//16 floored at 4."""
    from tpurt.kernels.traverse import stage_caps

    for p in (8, 16, 64, 1024, 4096, 6144):
        expect = [c for c in (p // 2, p // 4, p // 8, p // 16, p // 32,
                              p // 64) if c >= 8]
        assert stage_caps(p) == expect, p
    for n_pk in (4, 8, 48, 1024):
        expect = [c for c in (n_pk // 2, n_pk // 4, n_pk // 8, n_pk // 16)
                  if c >= 4]
        assert stage_caps(n_pk, floor=4, max_stages=4) == expect, n_pk
    assert stage_caps(4) == []           # below the traversal floor
    assert stage_caps(6144)[-1] >= 8     # ladder never under-floors
