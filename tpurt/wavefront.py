"""Wavefront tracer: SoA ray queues + compaction + Russian roulette
(SURVEY.md §1 L6', §3.3; BASELINE config 4).

Where the megakernel (trace.py) carries dead lanes masked to the bitter end,
the wavefront backend makes ray death *shrink the work*: the bounce loop
runs at the host level, each bounce is one jitted pass over the queue, and
between bounces the queue is compacted — a stable argsort on
``(liveness desc, material asc)`` (the BASELINE-mandated "ray compaction by
material/liveness sort") — then sliced down to the next power-of-two bucket
that holds the survivors. Shapes stay static per bucket (XLA-friendly,
bounded recompiles: one per bucket size), while arithmetic per bounce decays
with the live-ray population.

Radiance commits deterministically the moment a ray dies (SURVEY.md §7
hard part 4). The PRODUCTION paths (trace_chunk_staged, trace_static)
commit into a rad_out buffer in ORIGINAL queue order via packet-row
writes through the queue's slot provenance — a per-ray ``segment_sum``
(a scatter-add with duplicate indices, which XLA's GPU backend may run
with atomics in no fixed order) survives only in the host-loop test oracle (trace_chunk)
and the persistent mode, where regeneration forces it. Per-ray math and RNG streams are
identical to the megakernel, so the two backends are mutual oracles up
to float summation order (SURVEY.md §4 "Property" row).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera as camera_mod
from . import materials, rng, trace
from .geometry import INF
from .scene import Scene

MIN_BUCKET = 1024


class Queue(NamedTuple):
    """SoA ray queue; every field row i describes the same ray."""

    o: jnp.ndarray       # (N,3)
    d: jnp.ndarray       # (N,3)
    atten: jnp.ndarray   # (N,3)
    rad: jnp.ndarray     # (N,3) radiance accumulated so far by this ray
    pix: jnp.ndarray     # (N,)  flat pixel id (film segment)
    key: jnp.ndarray     # (3,N) threefry stream state [pixel, sample, seed]
    alive: jnp.ndarray   # (N,) bool
    slot: jnp.ndarray    # (N,) original queue row (compaction provenance;
    #                      packet-aligned rays keep 128-row blocks intact,
    #                      so slot[i]//PACKET_R is the packet's original
    #                      index — lets trace_chunk_staged commit radiance
    #                      as cheap packet-row writes instead of a per-ray
    #                      segment_sum)


@partial(jax.jit, static_argnames=("rr_start", "compact"))
def step(scene: Scene, queue: Queue, bounce, rr_start, compact: bool = True):
    """One wavefront bounce pass: intersect -> emit/sky -> scatter -> RR ->
    (optionally) compaction sort.

    compact=False skips the end-of-bounce packet sort + queue row moves.
    Packet ORDER is irrelevant to
    the traversal (cursors are per-packet, rays never change packets), so
    sorting live packets to the front matters only where a SHRINK is
    about to slice the queue — the staged path now sorts once at each
    shrink boundary (_compact_packets) instead of every bounce, deleting
    a (pk,) argsort plus eight full-queue row permutes per bounce.
    Radiance output is identical either way (commits go through slot
    provenance).

    Radiance stays in the queue; it is committed to the film exactly once
    per ray — when the ray's row is dropped by a shrink (trace_chunk) or at
    the end (commit_remaining); a per-step segment_sum over the full
    frame dominated wavefront overhead.

    Returns (sorted queue, live_count, rays_cast).
    """
    o, d, atten, rad, pix, key, alive, slot = queue
    rays_cast = jnp.sum(alive, dtype=jnp.int32)

    h = trace.intersect(scene, o, d, t_cap=jnp.where(alive, INF, 0.0))
    live_hit = alive & h.ok
    live_miss = alive & ~h.ok

    rad = rad + jnp.where(live_miss[:, None],
                          atten * trace.sky(scene, d), 0.0)
    mp = scene.mat_packed[h.mat]                   # ONE (N,16) param gather
    mtype = jax.lax.bitcast_convert_type(mp[:, 0], jnp.int32)
    rad = rad + jnp.where(live_hit[:, None], atten * mp[:, 4:7], 0.0)

    draws = rng.bounce_draws(key, bounce)
    p = o + h.t[:, None] * d
    new_d, att, s_alive = materials.scatter(
        d, h.n, h.front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws,
    )
    atten = jnp.where(live_hit[:, None], atten * att, atten)
    next_alive = live_hit & s_alive
    o = jnp.where(live_hit[:, None], p, o)
    d = jnp.where(live_hit[:, None], new_d, d)

    if rr_start is not None:
        p_surv = jnp.clip(jnp.max(atten, axis=-1),
                          trace.RR_CLAMP_LO, trace.RR_CLAMP_HI)
        rr_on = (bounce >= rr_start) & next_alive
        survive = draws[4] < p_surv
        atten = jnp.where((rr_on & survive)[:, None],
                          atten / p_surv[:, None], atten)
        next_alive = next_alive & (~rr_on | survive)

    # Compaction at PACKET granularity: packets with any live ray first,
    # stable — rays never leave their 128-ray traversal packet, so the
    # tile-order origin coherence that the packet BVH walk depends on is
    # preserved. A ray-level (octant, material) sort lost on the previous
    # accelerator: direction-major grouping pulls
    # origins from across the whole batch footprint and WIDENS the
    # per-packet node-set union. Liveness compaction (the BASELINE
    # "ray compaction by liveness") now moves P rows per bounce, not N.
    n = o.shape[0]
    live_rays = jnp.sum(next_alive, dtype=jnp.int32)
    if not compact:
        queue = Queue(o=o, d=d, atten=atten, rad=rad, pix=pix, key=key,
                      alive=next_alive, slot=slot)
        return queue, (live_rays, live_rays), rays_cast
    if n % trace.PACKET_R == 0:
        queue = _compact_packets(Queue(
            o=o, d=d, atten=atten, rad=rad, pix=pix, key=key,
            alive=next_alive, slot=slot))
        pk = n // trace.PACKET_R
        live_pk = jnp.any(next_alive.reshape(pk, trace.PACKET_R), axis=-1)
        # rows [live_packets*PACKET_R:] are all dead — the shrink bound
        live_rows = jnp.sum(live_pk, dtype=jnp.int32) * trace.PACKET_R
    else:
        # non-packet-aligned queue (tests, tiny scenes): liveness-only
        # stable sort, which also preserves relative ray order
        order = jnp.argsort(~next_alive, stable=True)
        queue = Queue(
            o=o[order], d=d[order], atten=atten[order], rad=rad[order],
            pix=pix[order], key=key[:, order], alive=next_alive[order],
            slot=slot[order],
        )
        live_rows = live_rays
    return queue, (live_rows, live_rays), rays_cast


def _compact_packets(q: Queue) -> Queue:
    """Stable packet-granular liveness compaction: packets with any live
    ray first; rays never leave their 128-ray traversal packet, so the
    tile-order origin coherence the packet BVH walk depends on is
    preserved (a ray-level (octant, material) sort lost on the previous
    accelerator). After this, queue rows
    [live_packets * PACKET_R:] are all dead."""
    n = q.o.shape[0]
    pk = n // trace.PACKET_R
    live_pk = jnp.any(q.alive.reshape(pk, trace.PACKET_R), axis=-1)
    order_pk = jnp.argsort(~live_pk, stable=True)

    def rows(a):
        return a.reshape(pk, -1)[order_pk].reshape(a.shape)

    return Queue(
        o=rows(q.o), d=rows(q.d), atten=rows(q.atten), rad=rows(q.rad),
        pix=rows(q.pix), alive=rows(q.alive), slot=rows(q.slot),
        key=q.key.reshape(3, pk, -1)[:, order_pk].reshape(q.key.shape),
    )


@jax.jit
def commit_remaining(film, queue: Queue):
    """Commit every row still in the queue: dead rows' radiance froze when
    they died (all accumulation is live-masked), live rows' is final at
    max-depth termination (A.8 'return black' for the unfinished tail)."""
    return film + jax.ops.segment_sum(
        queue.rad, queue.pix, num_segments=film.shape[0]
    )


@jax.jit
def commit_rows(film, rad, pix):
    """Commit the rows about to be dropped by a queue shrink."""
    return film + jax.ops.segment_sum(rad, pix, num_segments=film.shape[0])


def _bucket(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


BOUNCES_PER_DISPATCH = 4


@partial(jax.jit, static_argnames=("rr_start", "n_steps"))
def multi_step(scene: Scene, queue: Queue, bounce0, rr_start,
               n_steps: int = BOUNCES_PER_DISPATCH):
    """TEST ORACLE — superseded in production by trace_chunk_staged (which
    stages the whole bounce loop on-device); kept as the host-level
    differential oracle for tests/test_compaction.py.

    n_steps bounce passes in ONE device dispatch. The host round-trip
    per dispatch (live-count fetch) was a large fraction of wavefront
    wall time at one dispatch per bounce; shrink
    decisions now happen every n_steps bounces instead. Dead lanes carry
    zero-width t windows, so post-extinction steps inside a dispatch are
    nearly free."""
    total = jnp.int32(0)
    live = (jnp.int32(0), jnp.int32(0))
    for i in range(n_steps):
        queue, live, cast = step(scene, queue, bounce0 + jnp.int32(i),
                                 rr_start)
        total = total + cast
    return queue, live, total


def trace_chunk(scene: Scene, film, queue: Queue, max_depth: int,
                rr_start, live_history: list | None = None
                ) -> tuple[jnp.ndarray, int]:
    """TEST ORACLE — the host-level shrinking-bucket wavefront loop,
    superseded in production by trace_chunk_staged (one on-device
    dispatch). Kept because tests/test_compaction.py uses it as the
    differential oracle for the staged path (same RNG, same per-ray math,
    independently-structured control flow).

    Host-level bounce loop over one ray chunk. film: (npix,3) device
    array. Returns (film', rays_cast). live_history (optional list) gets
    the live-ray count appended per dispatch — the wavefront occupancy
    metric (SURVEY.md §5)."""
    total_rays = 0
    n = queue.o.shape[0]
    for bounce0 in range(0, max_depth, BOUNCES_PER_DISPATCH):
        n_steps = min(BOUNCES_PER_DISPATCH, max_depth - bounce0)
        queue, (live_rows, live_rays), cast = multi_step(
            scene, queue, jnp.int32(bounce0), rr_start, n_steps)
        total_rays += int(cast)
        live = int(live_rows)            # shrink bound (packet-aligned)
        if live_history is not None:
            live_history.append(int(live_rays))
        if live == 0:
            break
        b = _bucket(live)
        if b < n:
            # rows [b:] are dead (sorted live-first); their radiance is
            # final — commit exactly once, then drop them
            film = commit_rows(film, queue.rad[b:], queue.pix[b:])
            queue = queue._replace(
                o=queue.o[:b], d=queue.d[:b], atten=queue.atten[:b],
                rad=queue.rad[:b], pix=queue.pix[:b],
                key=queue.key[:, :b], alive=queue.alive[:b],
                slot=queue.slot[:b],
            )
            n = b
    film = commit_remaining(film, queue)
    return film, total_rays


@partial(jax.jit, static_argnames=("max_depth", "rr_start"))
def trace_chunk_staged(scene: Scene, queue: Queue, max_depth: int,
                       rr_start):
    """Whole-chunk wavefront bounce loop in ONE device dispatch, with
    STAGED on-device queue shrinking.

    The host-loop wavefront (trace_chunk / the render pipeline around it)
    was several times slower than the megakernel on c4: per-multi_step
    live-count fetches and shrink dispatches dominate. Here the
    per-bounce passes, the packet-granular liveness compaction AND the
    bucket shrinks all run inside one jit — the same staging trick as
    trace.trace's bounce loop. Because step() sorts live packets to
    the front, a shrink is a static slice; the dropped rows are all dead,
    so their radiance commits at the shrink and they never come back.

    Radiance commits into rad_out — a buffer in ORIGINAL queue order,
    written one PACKET ROW (128x3 floats) at a time via the queue's slot
    provenance, instead of per-ray `segment_sum(rad, pix)` commits
    several times per chunk: packet-row writes move 128-ray blocks and
    never collide. The caller folds rad_out into its
    tile-ordered film with a contiguous slice-add (render._wavefront_frame),
    exactly like the megakernel path.

    Returns (rad_out (N,3) in the INPUT queue order, rays_cast,
    live_hist (max_depth,) int32) — live_hist is the per-bounce live-ray
    count, the wavefront occupancy metric (SURVEY.md §5), recorded
    on-device.
    """
    n = queue.o.shape[0]
    assert n % trace.PACKET_R == 0, "staged wavefront needs packet-aligned queues"
    pk0 = n // trace.PACKET_R
    rw = trace.PACKET_R * 3

    def cond(c):
        bounce, q = c[0], c[1]
        return (bounce < max_depth) & jnp.any(q.alive)

    def body(c):
        # rad_out is NOT in the carry: the bounce bodies never touch it
        # (commits happen between the while_loops, at shrink boundaries)
        # and an untouched 6 MB carry plane risks a while-carry copy per
        # bounce
        bounce, q, nrays, hist = c
        # compact=False: packet order is traversal-irrelevant, so the
        # sort + 8 row permutes run ONCE per shrink below, not per bounce
        q, (live_rows, live_rays), cast = step(scene, q, bounce, rr_start,
                                               compact=False)
        hist = hist.at[bounce].set(live_rays)
        return bounce + 1, q, nrays + cast, hist

    def commit(rad_out, q, b):
        """Write queue rows [b:] home as packet rows (slot blocks are
        128-aligned: rays never leave their packet)."""
        spk = q.slot[b::trace.PACKET_R] // trace.PACKET_R
        return rad_out.at[spk].set(q.rad[b:].reshape(-1, rw))

    def run(c, rad_out, caps):
        if not caps:
            return jax.lax.while_loop(cond, body, c), rad_out
        cap = caps[0]
        pk = c[1].o.shape[0] // trace.PACKET_R
        if pk <= cap:
            return run(c, rad_out, caps[1:])

        def cond2(c):
            q = c[1]
            live_pk = jnp.sum(jnp.any(
                q.alive.reshape(-1, trace.PACKET_R), axis=-1),
                dtype=jnp.int32)
            return cond(c) & (live_pk > cap)

        c = jax.lax.while_loop(cond2, body, c)
        bounce, q, nrays, hist = c
        q = _compact_packets(q)   # live packets to the front, ONCE
        b = cap * trace.PACKET_R
        rad_out = commit(rad_out, q, b)
        q = Queue(o=q.o[:b], d=q.d[:b], atten=q.atten[:b], rad=q.rad[:b],
                  pix=q.pix[:b], key=q.key[:, :b], alive=q.alive[:b],
                  slot=q.slot[:b])
        return run((bounce, q, nrays, hist), rad_out, caps[1:])

    caps = [c for c in (pk0 // 2, pk0 // 4, pk0 // 8, pk0 // 16,
                        pk0 // 32) if c >= 8]
    init = (jnp.int32(0), queue, jnp.int32(0),
            jnp.zeros(max_depth, jnp.int32))
    (_, queue, nrays, hist), rad_out = run(
        init, jnp.zeros((pk0, rw), jnp.float32), caps)
    rad_out = commit(rad_out, queue, 0)
    return rad_out.reshape(n, 3), nrays, hist


def trace_static(scene: Scene, queue: Queue, max_depth: int, rr_start):
    """Device-resident wavefront loop with a fixed-capacity queue.

    Used where the host-level shrinking-bucket loop can't run — inside
    ``shard_map`` (SPMD requires identical shapes on every chip) — so the
    queue keeps its full size and dead lanes stay masked. The fixed queue
    never shrinks, so the per-bounce compaction sort buys nothing here
    (packet order is traversal-irrelevant) and is skipped.
    Semantically identical to trace_chunk (same RNG, same per-ray math).

    Returns (radiance (N,3) in the INPUT queue order, rays_cast) — the
    caller folds it into its film (mesh._device_trace reduces the sample
    axis and slice-adds, like the megakernel path). Packet-aligned
    queues unshuffle via slot at packet-row granularity instead of a
    per-ray ``segment_sum`` in every shard_map sub-block; non-aligned
    ones (tiny test frames) via a per-ray scatter on their own scale
    (slots are a permutation, so no two writes collide).
    """
    n = queue.o.shape[0]

    def cond(c):
        bounce, q, _ = c
        return (bounce < max_depth) & jnp.any(q.alive)

    def body(c):
        bounce, q, nrays = c
        q, _, cast = step(scene, q, bounce, rr_start, compact=False)
        return bounce + 1, q, nrays + cast

    init = (jnp.int32(0), queue, jnp.int32(0))
    _, queue, nrays = jax.lax.while_loop(cond, body, init)
    if n % trace.PACKET_R == 0:
        rw = trace.PACKET_R * 3
        spk = queue.slot[::trace.PACKET_R] // trace.PACKET_R
        rad = jnp.zeros((n // trace.PACKET_R, rw), jnp.float32).at[spk].set(
            queue.rad.reshape(-1, rw)).reshape(n, 3)
    else:
        rad = jnp.zeros((n, 3), jnp.float32).at[queue.slot].set(queue.rad)
    return rad, nrays


@partial(jax.jit,
         static_argnames=("max_depth", "rr_start", "capacity"))
def trace_persistent(scene: Scene, cam, film, pixel_table, sample_lo,
                     n_samples, seed, width, height,
                     max_depth: int, rr_start, capacity: int):
    """Persistent wavefront: a fixed-capacity ray pool at ~100% occupancy.

    The classic wavefront regeneration design, fully on-device: queue slots
    hold rays at DIFFERENT bounce depths (per-slot bounce counters feed the
    per-ray RNG streams); the moment a ray dies its radiance is
    scatter-added to the film and the slot is refilled with the next
    (pixel, sample) ray from a global counter — so, unlike the megakernel
    (dead lanes masked) or the shrinking wavefront (power-of-two buckets +
    host round trips), every lane does useful work every iteration and the
    whole chunk is ONE device dispatch.

    pixel_table: (npix_chunk,) pixel ids in tile order; the chunk streams
    npix_chunk * n_samples rays through `capacity` slots. Returns
    (film', rays_cast, occupancy, iterations).

    Verdict on the previous accelerator (81920-tri mesh): several times
    SLOWER than the staged megakernel despite near-100% lane occupancy —
    regeneration
    mixes fresh primary rays into packets holding old deep rays, which
    destroys the direction/origin coherence the packet BVH walk depends
    on, and constant occupancy means the staged tail compaction never
    engages. On this architecture coherence beats occupancy; the mode is
    kept as the occupancy-optimal reference point and for scenes where
    traversal is cheap relative to shading. The per-iteration
    `film.at[pix].add` below is a scatter-add with duplicate pixel ids;
    XLA's GPU backend may run it with atomics in no fixed order, so this
    mode need not be bit-reproducible there (not measured). It cannot be batched away because a
    slot's radiance must commit before the slot refills.
    """
    npix_chunk = pixel_table.shape[0]
    total = npix_chunk * jnp.asarray(n_samples, jnp.int32)

    def load_rays(r, valid):
        """Materialize rays for global ray indices r (K,) where valid."""
        smp = sample_lo + r // npix_chunk
        pos = jnp.where(valid, r % npix_chunk, 0)
        pix = pixel_table[pos]
        streams = rng.make_streams(seed, pix, smp)
        jit2 = rng.camera_draws(streams)
        o, d = camera_mod.generate_rays(cam, width, height, pix, jit2)
        return o, d, pix, streams

    r0 = jnp.arange(capacity, dtype=jnp.int32)
    valid0 = r0 < total
    o, d, pix, streams = load_rays(r0, valid0)
    init = (
        film, o, d,
        jnp.ones((capacity, 3), jnp.float32),   # atten
        jnp.zeros((capacity, 3), jnp.float32),  # rad
        pix, streams,
        jnp.zeros(capacity, jnp.int32),         # per-slot bounce
        valid0,                                 # alive
        jnp.minimum(jnp.int32(capacity), total),  # counter
        jnp.int32(0),                           # rays cast
        jnp.int32(0),                           # iterations
    )

    def cond(c):
        return jnp.any(c[8])

    def body(c):
        (film, o, d, atten, rad, pix, streams, bounce, alive, counter,
         nrays, iters) = c
        nrays = nrays + jnp.sum(alive, dtype=jnp.int32)
        iters = iters + 1

        h = trace.intersect(scene, o, d,
                            t_cap=jnp.where(alive, INF, 0.0))
        live_hit = alive & h.ok
        live_miss = alive & ~h.ok
        rad = rad + jnp.where(live_miss[:, None],
                              atten * trace.sky(scene, d), 0.0)
        mp = scene.mat_packed[h.mat]
        mtype = jax.lax.bitcast_convert_type(mp[:, 0], jnp.int32)
        rad = rad + jnp.where(live_hit[:, None],
                              atten * mp[:, 4:7], 0.0)

        draws = rng.bounce_draws(streams, bounce)   # per-slot bounce depth
        p = o + h.t[:, None] * d
        new_d, att, s_alive = materials.scatter(
            d, h.n, h.front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws,
        )
        atten = jnp.where(live_hit[:, None], atten * att, atten)
        alive = live_hit & s_alive
        o = jnp.where(live_hit[:, None], p, o)
        d = jnp.where(live_hit[:, None], new_d, d)

        if rr_start is not None:
            p_surv = jnp.clip(jnp.max(atten, axis=-1),
                              trace.RR_CLAMP_LO, trace.RR_CLAMP_HI)
            rr_on = (bounce >= rr_start) & alive
            survive = draws[4] < p_surv
            atten = jnp.where((rr_on & survive)[:, None],
                              atten / p_surv[:, None], atten)
            alive = alive & (~rr_on | survive)

        bounce = jnp.where(live_hit, bounce + 1, bounce)
        alive = alive & (bounce < max_depth)        # A.8 depth cut

        # Regeneration: dead slots commit their ray's radiance and take the
        # next ray off the global counter (slot-order deterministic).
        dead = ~alive
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        new_r = counter + rank
        refill = dead & (new_r < total)
        film = film.at[pix].add(jnp.where(refill[:, None], rad, 0.0))
        o2, d2, pix2, streams2 = load_rays(jnp.where(refill, new_r, 0),
                                           refill)
        o = jnp.where(refill[:, None], o2, o)
        d = jnp.where(refill[:, None], d2, d)
        pix = jnp.where(refill, pix2, pix)
        streams = jnp.where(refill[None, :], streams2, streams)
        atten = jnp.where(refill[:, None], 1.0, atten)
        rad = jnp.where(refill[:, None], 0.0, rad)
        bounce = jnp.where(refill, 0, bounce)
        alive = alive | refill
        counter = counter + jnp.sum(refill, dtype=jnp.int32)

        return (film, o, d, atten, rad, pix, streams, bounce, alive,
                counter, nrays, iters)

    (film, _, _, _, rad, pix, _, _, _, _, nrays, iters) = (
        jax.lax.while_loop(cond, body, init)
    )
    # every slot's current occupant commits exactly once here (refilled
    # slots committed their previous occupants at refill time)
    film = film.at[pix].add(rad)
    occ = nrays.astype(jnp.float32) / jnp.maximum(
        iters.astype(jnp.float32) * capacity, 1.0
    )
    return film, nrays, occ, iters


def make_queue(o, d, pix, keys, alive=None) -> Queue:
    n = o.shape[0]
    return Queue(
        o=o, d=d,
        atten=jnp.ones((n, 3), jnp.float32),
        rad=jnp.zeros((n, 3), jnp.float32),
        pix=pix.astype(jnp.int32),
        key=keys,
        alive=jnp.ones(n, bool) if alive is None else alive,
        slot=jnp.arange(n, dtype=jnp.int32),
    )
