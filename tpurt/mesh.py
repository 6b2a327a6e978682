"""Multi-card rendering: shard_map over the device mesh + one film
collective (SURVEY.md §1 L0/L9, §2 "Distributed communication backend").

Replaces the reference's thread-pool work queue: instead of worker threads
pulling tile indices from an atomic counter, the frame's flat pixel axis is
statically sharded across a 1-D ``('chips',)`` mesh over
``jax.devices()`` — each card traces its own pixel block in lockstep SPMD,
and the only cross-card traffic is the final film collective, which XLA
hands to NCCL over NVLink (the cards of one host are joined all to all,
so the mesh follows the algorithm alone):

  * shard='tiles': pixels sharded, film stays sharded (all_gather happens
    implicitly when the host reads the global array); ray-count psum.
  * shard='spp' : the DP-over-samples alternative (SURVEY.md §2 table, TP
    analog) — every chip renders all pixels with a disjoint slice of the
    sample indices, film is psum-reduced across cards.

Because RNG streams are (pixel, sample)-counter-derived, both shardings
produce the same image as the 1-chip render up to float summation order —
asserted by the fake-mesh tests (SURVEY.md §4 Distributed row).

The checkpointable unit is ``render_samples_sharded`` (mirrors
render.render_samples): it accumulates the radiance SUM of a sample range
into a host film array, so checkpoint/resume composes with sharding
(SURVEY.md §5 checkpoint bullet — written about config 5's multi-chip
renders).

Runs on every local card by default (a 1-card mesh on a one-GPU host);
tested on an 8-device forced-CPU mesh and checked on four H100s by
``chip_smoke.py --four-card``. All device buffers are explicitly placed on
the mesh (device_put with a NamedSharding), never on the default backend,
so the whole module works on a mesh that is NOT the default platform —
e.g. the fake CPU mesh while the GPU client can't even initialize.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from . import camera as camera_mod
from . import rng, trace, wavefront
from .config import RenderConfig, build_scene
from .scene import Scene

AXIS = "chips"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


# Per-card pixel sub-block. Smaller than ray_batch: on c5 (4K, depth 16,
# rr 3) a 512k sub-block was no faster on the previous accelerator — at
# contract depth the round-floor-bound deep-bounce tail dominates, and
# batch width only compresses fresh bounces. Not yet measured on the H100.
SUB_BLOCK = 1 << 17


def _device_trace(scene: Scene, cam, gpix, gvalid, sample_ids, seed,
                  width, height, mode: str, max_depth: int, rr_start):
    """Trace one device's (pixel-block × sample-slice); returns the
    per-pixel radiance sum (B,3) and rays-cast scalar. Pure SPMD body.

    gvalid masks tile-padding rows (gpix entries duplicated to round the
    pixel count up to the mesh size): pad rays start dead, so they are
    never traced and never counted — the psum'd ray counter (the Mrays
    numerator, SURVEY.md §5 Metrics) counts real pixels only.

    Large per-chip blocks (config 5: a whole 4K frame on the 1-chip mesh)
    loop on-device over SUB_BLOCK pixel sub-blocks — same dispatch-floor
    logic as render._accum_frame, and the traversal runs at its tuned
    batch size instead of one multi-million-ray megabatch.
    """
    b = gpix.shape[0]
    c = sample_ids.shape[0]

    def fold(rad, bb):
        # per-pixel sample sum (ascending sample order)
        return rad.reshape(c, bb, 3).sum(axis=0)

    def trace_block(pix_blk, valid_blk):
        bb = pix_blk.shape[0]
        pix = jnp.tile(pix_blk, c)
        valid = jnp.tile(valid_blk, c)
        smp = jnp.repeat(sample_ids, bb)
        keys = rng.make_streams(seed, pix, smp)
        jit2 = rng.camera_draws(keys)
        o, d = camera_mod.generate_rays(cam, width, height, pix, jit2)
        if mode == "primary":
            rad, _ = trace.shade_primary(scene, o, d)
            rad = jnp.where(valid[:, None], rad, 0.0)
            nrays = jnp.sum(valid, dtype=jnp.int32)
        elif mode == "wavefront":
            ar = jnp.arange(bb, dtype=jnp.int32)
            lpix = jnp.tile(ar, c)
            queue = wavefront.make_queue(o, d, lpix, keys, alive=valid)
            rad, nrays = wavefront.trace_static(scene, queue,
                                                max_depth, rr_start)
            # rad is in original queue order: reduce the sample axis
            # like the mega branch — no per-ray segment_sum
            return fold(rad, bb), nrays
        else:
            rad, nrays = trace.trace(scene, o, d, keys, max_depth,
                                     rr_start, valid=valid)
        return fold(rad, bb), nrays

    sb = SUB_BLOCK
    if b <= sb or b % sb != 0:
        return trace_block(gpix, gvalid)

    def body(bi, carry):
        rad_acc, nrays_acc = carry
        p0 = bi * sb
        rad, nrays = trace_block(
            jax.lax.dynamic_slice(gpix, (p0,), (sb,)),
            jax.lax.dynamic_slice(gvalid, (p0,), (sb,)),
        )
        rad_acc = jax.lax.dynamic_update_slice(rad_acc, rad, (p0, 0))
        return rad_acc, nrays_acc + nrays

    return jax.lax.fori_loop(
        0, b // sb, body,
        (jnp.zeros((b, 3), jnp.float32), jnp.int32(0)),
    )


@partial(jax.jit,
         static_argnames=("mesh", "mode", "max_depth", "rr_start",
                          "width", "height"))
def _tiles_chunk(scene: Scene, cam, gpix_pad, gvalid_pad, sample_ids, seed,
                 mesh: Mesh, mode: str, max_depth: int, rr_start,
                 width: int, height: int):
    """One sample-chunk over the pixel-sharded frame."""

    def body(scene, cam, gpix_block, gvalid_block, sample_ids, seed):
        rad, nrays = _device_trace(scene, cam, gpix_block, gvalid_block,
                                   sample_ids, seed,
                                   width, height, mode, max_depth, rr_start)
        return rad, jax.lax.psum(nrays, AXIS)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(AXIS), P()),
        check_vma=False,  # while_loop carries start as replicated constants
    )
    return fn(scene, cam, gpix_pad, gvalid_pad, sample_ids, seed)


@partial(jax.jit,
         static_argnames=("mesh", "mode", "max_depth", "rr_start",
                          "width", "height"))
def _spp_chunk(scene: Scene, cam, pixel_ids, sample_ids_pad, seed,
               mesh: Mesh, mode: str, max_depth: int, rr_start,
               width: int, height: int):
    """One pixel-block over the sample-sharded axis; film psum across
    cards."""

    def body(scene, cam, pixel_ids, sample_block, seed):
        valid = jnp.ones(pixel_ids.shape, bool)
        rad, nrays = _device_trace(scene, cam, pixel_ids, valid,
                                   sample_block, seed,
                                   width, height, mode, max_depth, rr_start)
        return jax.lax.psum(rad, AXIS), jax.lax.psum(nrays, AXIS)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,  # while_loop carries start as replicated constants
    )
    return fn(scene, cam, pixel_ids, sample_ids_pad, seed)


def render_samples_sharded(cfg: RenderConfig, scene: Scene, cam,
                           sample_start: int, sample_stop: int,
                           film_flat: Optional[np.ndarray] = None,
                           mesh: Optional[Mesh] = None):
    """Accumulate the radiance *sum* of samples [sample_start, sample_stop)
    over the mesh into film_flat (npix, 3) — a HOST array, so the result is
    directly checkpointable. Returns (film_flat, rays_cast).

    Like render.render_samples, this is the checkpointable unit: RNG
    streams are (pixel, sample)-counter-derived, so any grouping of the
    sample range — one call, many calls, across a resume, across different
    mesh sizes — produces the same sum.
    """
    if mesh is None:
        mesh = make_mesh()
    ndev = mesh.size

    repl = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(AXIS))
    scene = jax.device_put(scene, repl)
    cam = jax.device_put(cam, repl)

    npix = cfg.width * cfg.height
    seed = jax.device_put(np.uint32(cfg.seed), repl)
    if film_flat is None:
        film_flat = np.zeros((npix, 3), np.float32)
    total_rays = 0
    n_samples = sample_stop - sample_start

    if cfg.shard == "spp":
        if n_samples % ndev:
            raise ValueError(
                f"spp sharding needs the sample count ({n_samples}) "
                f"divisible by the mesh size ({ndev}); pick shard='tiles' "
                f"otherwise"
            )
        per_dev = n_samples // ndev
        pixel_block = min(npix, max(1, cfg.ray_batch // ndev))
        film_acc = jax.device_put(film_flat.astype(np.float32), repl)
        # chunk the per-device sample count so each SPMD call stays bounded
        chunk = max(1, min(per_dev,
                           cfg.ray_batch // max(1, pixel_block)))
        for p0 in range(0, npix, pixel_block):
            p1 = min(p0 + pixel_block, npix)
            pixel_ids = jax.device_put(
                np.arange(p0, p1, dtype=np.int32), repl
            )
            for s0 in range(0, per_dev, chunk):
                s1 = min(s0 + chunk, per_dev)
                # device k takes samples [start + k*per_dev + s0, ... + s1)
                blocks = [
                    np.arange(sample_start + k * per_dev + s0,
                              sample_start + k * per_dev + s1,
                              dtype=np.int32)
                    for k in range(ndev)
                ]
                sample_ids = jax.device_put(np.concatenate(blocks), sharded)
                rad, nrays = _spp_chunk(
                    scene, cam, pixel_ids, sample_ids, seed, mesh,
                    cfg.mode, cfg.max_depth, cfg.rr_start,
                    cfg.width, cfg.height,
                )
                film_acc = film_acc.at[p0:p1].add(rad)
                total_rays += int(nrays)
        film_flat = np.asarray(jax.block_until_ready(film_acc))
    else:  # tiles
        from . import render as render_mod

        npix_pad = -(-npix // ndev) * ndev
        block = npix_pad // ndev
        if block > SUB_BLOCK:
            # round the per-chip block up to a SUB_BLOCK multiple so
            # _device_trace's on-device sub-block loop engages
            block = -(-block // SUB_BLOCK) * SUB_BLOCK
            npix_pad = block * ndev
        order = render_mod._tile_order_cached(cfg.width, cfg.height)
        gpix = np.concatenate(
            [order, np.full(npix_pad - npix, order[-1], np.int32)]
        )
        gvalid = np.arange(npix_pad) < npix  # pad rows start dead
        gpix = jax.device_put(gpix, sharded)
        gvalid = jax.device_put(gvalid, sharded)
        spp_chunk = max(1, cfg.ray_batch // max(1, block))
        film_pad = jax.device_put(np.zeros((npix_pad, 3), np.float32),
                                  sharded)
        s0 = sample_start
        while s0 < sample_stop:
            cs = min(spp_chunk, sample_stop - s0)
            s1 = s0 + cs
            sample_ids = jax.device_put(np.arange(s0, s1, dtype=np.int32),
                                        repl)
            rad, nrays = _tiles_chunk(
                scene, cam, gpix, gvalid, sample_ids, seed, mesh,
                cfg.mode, cfg.max_depth, cfg.rr_start,
                cfg.width, cfg.height,
            )
            film_pad = film_pad + rad
            total_rays += int(nrays)
            s0 = s1
        # rows of film_pad follow the tile-order enumeration; un-permute on
        # the host (the film is being fetched anyway, and a device-side
        # un-permute would allocate on the DEFAULT backend, breaking
        # non-default meshes).
        pad_h = np.asarray(jax.block_until_ready(film_pad))
        film_flat = film_flat.copy()
        film_flat[order] += pad_h[:npix]
    return film_flat, total_rays


def render_sharded(cfg: RenderConfig, scene: Optional[Scene] = None,
                   cam=None, mesh: Optional[Mesh] = None):
    """Multi-chip render; same contract as render.render()."""
    if scene is None or cam is None:
        scene, cam = build_scene(cfg)
    if mesh is None:
        mesh = make_mesh()

    t0 = time.perf_counter()
    film_flat, total_rays = render_samples_sharded(
        cfg, scene, cam, 0, cfg.spp, mesh=mesh
    )
    film = (film_flat / cfg.spp).reshape(cfg.height, cfg.width, 3)
    wall = time.perf_counter() - t0

    from . import metrics

    stats = metrics.build_stats(total_rays, wall, cfg.width, cfg.height,
                                cfg.spp, devices=mesh.size, shard=cfg.shard)
    return film, stats
