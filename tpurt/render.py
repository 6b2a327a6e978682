"""Render loop: chunked ray batches over the device (SURVEY.md §1 L9).

Replaces the reference's thread-pool tile queue (SURVEY.md §2
"Thread-pool work queue"): instead of workers pulling tile indices from an
atomic counter, the frame is decomposed into (pixel-block × sample-chunk)
ray batches, each one jit-compiled XLA program invocation; accumulation is
a functional sum, so order never matters. Multi-card sharding lives in
mesh.py / shard_map (SURVEY.md §2 "Distributed communication backend") and
wraps this same per-card loop.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import camera as camera_mod
from . import rng, trace, wavefront
from .config import RenderConfig, build_scene
from .scene import Scene

# Batch cap for brute-force (no-BVH) bounce paths — see
# effective_ray_batch: without traversal rounds there is no per-batch
# link cost to amortize. Chosen on the previous accelerator; not yet
# measured on the H100.
BRUTE_RAY_BATCH = 1 << 17


def effective_ray_batch(cfg: RenderConfig, scene: Scene) -> int:
    """Per-path ray-batch budget (perf-only; images are invariant to
    chunk grouping by the counter-derived RNG contract).

    The ray_batch default (512k) is tuned for BVH traversal, whose
    per-round serial-link cost is per-BATCH. Brute-force bounce paths (no
    BVH) have no round links to amortize and larger batches only add
    volume (c2-cornell ran slower at 512k than at 128k on the previous
    accelerator), so they cap at BRUTE_RAY_BATCH. Primary mode keeps the
    full batch either way — one pass, no bounce loop, bigger batch =
    fewer chunk iterations."""
    if scene.pk_nodes is None and cfg.mode != "primary":
        return min(cfg.ray_batch, BRUTE_RAY_BATCH)
    return cfg.ray_batch

_TILE_W, _TILE_H = 16, 8  # one 128-ray traversal packet = one 16x8 tile


def tile_order(width: int, height: int) -> np.ndarray:
    """Pixel ids permuted so each run of 128 is (mostly) one 16x8 image
    tile. Traversal packets (trace.PACKET_R) are built from consecutive
    rays, so tile order makes primary packets spatially square — and keeps
    bounce-ray origins within a small world-space footprint — instead of
    the 128x1 scanline strips row-major order would give. The pixel id
    VALUES are unchanged (RNG streams and film indexing are id-keyed), so
    the image is identical; only the batching order changes."""
    xs = np.arange(width)
    ys = np.arange(height)
    gx, gy = np.meshgrid(xs, ys)                 # (H, W)
    key = (
        (gy // _TILE_H).astype(np.int64) * ((width + _TILE_W - 1) // _TILE_W)
        + (gx // _TILE_W)
    ) * (_TILE_W * _TILE_H) + (gy % _TILE_H) * _TILE_W + (gx % _TILE_W)
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


_tile_order_cache: dict = {}


def _tile_order_cached(width: int, height: int) -> np.ndarray:
    k = (width, height)
    if k not in _tile_order_cache:
        _tile_order_cache[k] = tile_order(width, height)
    return _tile_order_cache[k]


_order_pad_cache: dict = {}


def _order_pad_cached(width: int, height: int, block: int):
    """Device-resident (order_pad, valid_pad) for _accum_frame — uploaded
    once per (geometry, block): re-uploading ~1 MB of pixel ids per
    render_samples call costs a dispatch-floor round trip by itself."""
    k = (width, height, block)
    if k not in _order_pad_cache:
        npix = width * height
        npix_pad = -(-npix // block) * block
        order = _tile_order_cached(width, height)
        order_pad = jnp.asarray(np.concatenate(
            [order, np.full(npix_pad - npix, order[-1], np.int32)]
        ))
        valid_pad = jnp.asarray(np.arange(npix_pad) < npix)
        # inverse permutation: tile-layout row holding pixel p is
        # inv_order[p]. Precomputed so the frame epilogue is a GATHER
        # rather than a per-row scatter.
        inv_order = jnp.asarray(np.argsort(order).astype(np.int32))
        _order_pad_cache[k] = (order_pad, valid_pad, inv_order)
    return _order_pad_cache[k]


@partial(jax.jit,
         static_argnames=("width", "height", "mode", "max_depth",
                          "rr_start", "block", "c", "n_blocks"),
         donate_argnames=("film_flat", "nrays_acc"))
def _accum_frame(scene: Scene, cam, order_pad, valid_pad, inv_order,
                 film_flat, nrays_acc, s0, n_chunks, seed,
                 width: int, height: int, mode: str, max_depth: int,
                 rr_start, block: int, c: int, n_blocks: int):
    """Trace n_chunks sample-chunks x n_blocks pixel-blocks and fold them
    into the film — the ENTIRE frame pass as ONE device dispatch.

    Both loops run on-device as ``lax.fori_loop``s around the traced
    batch body, and the film's tile-order permute in/out lives INSIDE the
    dispatch too, so the only per-call costs are one dispatch and the
    final fetch, and no host sync sits between batches.

    n_chunks is TRACED (the outer fori becomes a while_loop) so a 1-sample
    warmup and an N-sample measured run share one compiled program.

    Internally the film lives in TILE ORDER (row i accumulates pixel
    order_pad[i]): the per-batch film update is then a contiguous
    dynamic_update_slice on a donated buffer instead of a per-row
    scatter-add.

    valid_pad masks the tail rows padding npix up to a block multiple: pad
    lanes are born dead (never traced, never counted) and their radiance
    rows are zero.
    """
    npix = width * height
    film_tiled = jnp.where(valid_pad[:, None], film_flat[order_pad], 0.0)

    def chunk_body(ci, carry):
        film_tiled, nrays_acc = carry
        sample_ids = s0 + ci * c + jnp.arange(c, dtype=jnp.int32)

        def block_body(bi, carry):
            film_tiled, nrays_acc = carry
            p0 = bi * block
            pix = jax.lax.dynamic_slice(order_pad, (p0,), (block,))
            valid = jax.lax.dynamic_slice(valid_pad, (p0,), (block,))
            pixf = jnp.tile(pix, c)                   # (B*C,) sample-major
            validf = jnp.tile(valid, c)
            smp = jnp.repeat(sample_ids, block)
            keys = rng.make_streams(seed, pixf, smp)
            jit2 = rng.camera_draws(keys)
            o, d = camera_mod.generate_rays(cam, width, height, pixf, jit2)

            if mode == "primary":
                rad, _ = trace.shade_primary(scene, o, d)
                rad = jnp.where(validf[:, None], rad, 0.0)
                nrays = jnp.sum(validf, dtype=jnp.int32)
            else:
                rad, nrays = trace.trace(scene, o, d, keys, max_depth,
                                         rr_start, valid=validf)
            rad = rad.reshape(c, block, 3).sum(axis=0)
            old = jax.lax.dynamic_slice(film_tiled, (p0, 0), (block, 3))
            film_tiled = jax.lax.dynamic_update_slice(
                film_tiled, old + rad, (p0, 0))
            return film_tiled, nrays_acc + nrays

        return jax.lax.fori_loop(0, n_blocks, block_body,
                                 (film_tiled, nrays_acc))

    film_tiled, nrays_acc = jax.lax.fori_loop(0, n_chunks, chunk_body,
                                              (film_tiled, nrays_acc))
    # permute-out via the precomputed INVERSE order: a row gather, not a
    # scatter
    film_flat = film_tiled[inv_order]
    return film_flat, nrays_acc


# Two regrouping engines lost on the previous accelerator and were deleted
# (ROADMAP lists them): cross-batch tail coalescing (fewer-but-wider
# rounds conserve wall) and sample-major packets (tile-order spatial
# coherence is what the packet footprint union feeds on). They live at
# commit 69c49fb. trace.trace's span-resume API (bounce0/atten0/rad0/
# want_state) is kept: it is the general bounce-span handoff contract,
# independently tested.


@partial(jax.jit, static_argnames=("width", "height"))
def _raygen(scene: Scene, cam, pixel_ids, sample_ids, seed,
            width: int, height: int):
    b = pixel_ids.shape[0]
    c = sample_ids.shape[0]
    pix = jnp.tile(pixel_ids, c)
    smp = jnp.repeat(sample_ids, b)
    keys = rng.make_streams(seed, pix, smp)
    jit2 = rng.camera_draws(keys)
    o, d = camera_mod.generate_rays(cam, width, height, pix, jit2)
    return wavefront.make_queue(o, d, pix, keys)


def render_samples(cfg: RenderConfig, scene: Scene, cam,
                   sample_start: int, sample_stop: int,
                   film_flat=None, stats_sink: Optional[dict] = None):
    """Accumulate the radiance *sum* of samples [sample_start, sample_stop)
    into film_flat (npix, 3). Returns (film_flat, rays_cast).

    This is the checkpointable unit: because RNG streams are derived from
    (pixel, sample) counters, rendering samples in any grouping — one call,
    many calls, across a resume — produces the same sum (SURVEY.md §5
    "Checkpoint / resume").
    """
    npix = cfg.width * cfg.height
    seed = jnp.uint32(cfg.seed)
    if film_flat is None:
        film_flat = jnp.zeros((npix, 3), jnp.float32)

    ray_batch = effective_ray_batch(cfg, scene)
    pixel_block = min(npix, ray_batch)
    pixel_block += (-pixel_block) % trace.PACKET_R
    spp_chunk = cfg.spp_chunk or max(1, ray_batch // pixel_block)
    spp_chunk = min(spp_chunk, max(1, sample_stop - sample_start))
    order = _tile_order_cached(cfg.width, cfg.height)

    if cfg.mode in ("primary", "mega"):
        # One device dispatch for the whole sample range: the
        # (sample-chunk x pixel-block) loops AND the tile-order film
        # permutes run on-device inside _accum_frame (see its
        # docstring); the padded order
        # arrays are uploaded once per geometry and cached.
        order_pad, valid_pad, inv_order = _order_pad_cached(
            cfg.width, cfg.height, pixel_block)
        nrays_acc = jnp.int32(0)
        n_blocks = order_pad.shape[0] // pixel_block
        n_samples = sample_stop - sample_start
        # full-size chunks in one dispatch; the ragged tail (if any) in a
        # second one (different static c => separate compile)
        for s0, c, n_chunks in (
            (sample_start, spp_chunk, n_samples // spp_chunk),
            (sample_start + (n_samples // spp_chunk) * spp_chunk,
             n_samples % spp_chunk, 1),
        ):
            if n_chunks == 0 or c == 0:
                continue
            film_flat, nrays_acc = _accum_frame(
                scene, cam, order_pad, valid_pad, inv_order,
                film_flat, nrays_acc,
                jnp.int32(s0), jnp.int32(n_chunks), seed,
                cfg.width, cfg.height, cfg.mode, cfg.max_depth,
                cfg.rr_start, pixel_block, c, n_blocks,
            )
        return film_flat, int(nrays_acc)

    if cfg.mode == "wavefront":
        return _render_wavefront(cfg, scene, cam, film_flat, order,
                                 pixel_block, spp_chunk,
                                 sample_start, sample_stop, seed, stats_sink)

    # cfg.mode == "persist": the persistent wavefront streams each pixel
    # block's whole sample range through one fixed-capacity dispatch
    assert cfg.mode == "persist", cfg.mode
    total_rays = 0
    for p0 in range(0, npix, pixel_block):
        p1 = min(p0 + pixel_block, npix)
        pixel_ids = jnp.asarray(order[p0:p1])
        n_smp = sample_stop - sample_start
        total = (p1 - p0) * n_smp
        capacity = min(ray_batch, total)
        capacity += (-capacity) % trace.PACKET_R
        film_flat, nrays, occ, iters = wavefront.trace_persistent(
            scene, cam, film_flat, pixel_ids,
            jnp.int32(sample_start), jnp.int32(n_smp), seed,
            cfg.width, cfg.height, cfg.max_depth, cfg.rr_start,
            capacity,
        )
        total_rays += int(nrays)
        if stats_sink is not None:
            stats_sink.setdefault("persist_occupancy", []).append(
                float(occ)
            )
    return film_flat, total_rays


@partial(jax.jit,
         static_argnames=("width", "height", "max_depth", "rr_start",
                          "block", "c", "n_blocks"),
         donate_argnames=("film_flat",))
def _wavefront_frame(scene: Scene, cam, order_pad, valid_pad, inv_order,
                     film_flat, s0, n_chunks, seed,
                     width: int, height: int, max_depth: int, rr_start,
                     block: int, c: int, n_blocks: int):
    """All wavefront chunks of a sample range as ONE device dispatch.

    The (pixel-block x sample-chunk) loop runs on-device as a fori_loop
    around raygen + wavefront.trace_chunk_staged (same rationale as
    _accum_frame). The film lives in TILE ORDER inside the dispatch so
    each chunk's radiance folds in as a contiguous slice-add
    (trace_chunk_staged returns original-queue-order radiance, so no
    per-ray segment_sum commit is needed); the permute-out is an
    inverse-order gather. Returns (film, rays_cast,
    live-per-bounce summed over chunks)."""
    film_tiled = jnp.where(valid_pad[:, None], film_flat[order_pad], 0.0)

    def chunk_body(ci, carry):
        film_tiled, nrays, hist = carry
        p0 = (ci % n_blocks) * block
        sample_ids = s0 + (ci // n_blocks) * c + jnp.arange(c,
                                                           dtype=jnp.int32)
        pix = jax.lax.dynamic_slice(order_pad, (p0,), (block,))
        valid = jax.lax.dynamic_slice(valid_pad, (p0,), (block,))
        pixf = jnp.tile(pix, c)
        validf = jnp.tile(valid, c)
        smp = jnp.repeat(sample_ids, block)
        keys = rng.make_streams(seed, pixf, smp)
        jit2 = rng.camera_draws(keys)
        o, d = camera_mod.generate_rays(cam, width, height, pixf, jit2)
        q = wavefront.make_queue(o, d, pixf, keys, alive=validf)
        rad, cast, h = wavefront.trace_chunk_staged(
            scene, q, max_depth, rr_start)
        rad = rad.reshape(c, block, 3).sum(axis=0)
        old = jax.lax.dynamic_slice(film_tiled, (p0, 0), (block, 3))
        film_tiled = jax.lax.dynamic_update_slice(
            film_tiled, old + rad, (p0, 0))
        return film_tiled, nrays + cast, hist + h

    init = (film_tiled, jnp.int32(0), jnp.zeros(max_depth, jnp.int32))
    film_tiled, nrays, hist = jax.lax.fori_loop(
        0, n_blocks * n_chunks, chunk_body, init)
    return film_tiled[inv_order], nrays, hist


def _render_wavefront(cfg, scene, cam, film_flat, order, pixel_block,
                      spp_chunk, sample_start, sample_stop, seed,
                      stats_sink):
    """Wavefront render loop: the whole sample range in one dispatch.

    Per-bounce queue passes, packet-granular liveness compaction and
    staged queue shrinks all run inside wavefront.trace_chunk_staged
    (a host-level bounce loop with per-multi_step live-count fetches
    was several times slower than the megakernel on c4); the chunk loop
    around it is also on-device
    (_wavefront_frame). Every chunk gets the SAME pixel count (ragged
    last block padded with duplicates of the last pixel, born dead), so
    one compiled program serves every chunk.
    """
    npix = cfg.width * cfg.height
    block = min(pixel_block, -(-npix // trace.PACKET_R) * trace.PACKET_R)
    order_pad, valid_pad, inv_order = _order_pad_cached(
        cfg.width, cfg.height, block)
    n_blocks = order_pad.shape[0] // block

    n_samples = sample_stop - sample_start
    total_rays = jnp.int32(0)
    hist = jnp.zeros(cfg.max_depth, jnp.int32)
    for s0, c, n_chunks in (
        (sample_start, spp_chunk, n_samples // spp_chunk),
        (sample_start + (n_samples // spp_chunk) * spp_chunk,
         n_samples % spp_chunk, 1),
    ):
        if n_chunks == 0 or c == 0:
            continue
        film_flat, nrays, h = _wavefront_frame(
            scene, cam, order_pad, valid_pad, inv_order, film_flat,
            jnp.int32(s0), jnp.int32(n_chunks), seed,
            cfg.width, cfg.height, cfg.max_depth, cfg.rr_start,
            block, c, n_blocks,
        )
        total_rays = total_rays + nrays
        hist = hist + h

    if stats_sink is not None:
        # hist sums live counts across ALL chunks per bounce slot, so the
        # denominator is the total queue slots issued per bounce slot
        # across all chunks: block * n_blocks * n_samples (the ragged
        # tail chunk contributes its own c — summed over the two
        # dispatch groups, exactly n_samples) — not one chunk's capacity
        # (which saturated occupancy at 1.0 on any multi-chunk render;
        # the pixel-block axis counts too).
        stats_sink["queue_capacity"] = block * n_blocks * n_samples
        stats_sink.setdefault("live_history", []).extend(
            int(x) for x in np.asarray(hist))
    return film_flat, int(total_rays)


def render(cfg: RenderConfig, scene: Optional[Scene] = None, cam=None):
    """Render a full frame on the local device.

    Returns (film (H,W,3) linear f32 ndarray, stats dict). The film is the
    per-pixel *mean* over cfg.spp samples (A.9).
    """
    if scene is None or cam is None:
        scene, cam = build_scene(cfg)
    scene = scene.device()

    from . import metrics

    sink: dict = {}
    t0 = time.perf_counter()
    film_flat, total_rays = render_samples(cfg, scene, cam, 0, cfg.spp,
                                           stats_sink=sink)
    film_flat = film_flat / cfg.spp
    film = np.asarray(jax.block_until_ready(film_flat)).reshape(
        cfg.height, cfg.width, 3
    )
    wall = time.perf_counter() - t0

    stats = metrics.build_stats(total_rays, wall, cfg.width, cfg.height,
                                cfg.spp)
    if "live_history" in sink:
        stats["occupancy"] = metrics.occupancy(
            sink["live_history"], sink.get("queue_capacity", 1)
        )
    if "persist_occupancy" in sink:
        occ = sink["persist_occupancy"]
        stats["occupancy"] = {"mean_occupancy": sum(occ) / len(occ),
                              "chunks": len(occ)}
    return film, stats
