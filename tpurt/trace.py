"""Megakernel tracer core (SURVEY.md §1 L6, §3.2).

The reference's recursive ``cast_ray(scene, ray, depth)`` (SURVEY.md §3.1)
becomes an iterative, batched bounce loop: one ``lax.while_loop`` whose carry
is the SoA state of N rays (origin, dir, attenuation, radiance, live mask).
All N rays advance one bounce per iteration; dead lanes are masked, and the
loop exits early when every lane is dead (``~alive.any()``), which is what
Russian roulette and sky misses feed.

BVH traversal is the inner ``lax.while_loop``: a single int32 node cursor
per ray walking the skip-linked DFS array (bvh.py) with the shrinking
``t_best`` as the pruning window — stackless by construction, so the carry
is three flat vectors and every step is gathers + a slab test + a fixed
(N, LEAF_N) Möller–Trumbore block.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import geometry, linalg, materials, rng
from .geometry import INF
from .kernels.traverse import (  # re-export
    PACKET_R, bvh_nearest_tri, packet_nearest_tri,
)
from .scene import Scene

RR_CLAMP_LO, RR_CLAMP_HI = 0.05, 0.95  # A.8
# Bounce-stage ladder parameters (see the staged-compaction comment in
# trace(); ladder generated by kernels.traverse.stage_caps; deeper
# ladders lost on the previous accelerator, not yet measured on the H100).
BOUNCE_STAGE_FLOOR = 4
BOUNCE_STAGE_MAX = 4     # deepest bounce stage: n_pk // 2^4
# Override: an explicit caps list for the bounce ladder — None selects
# the stage_caps() ladder above.
BOUNCE_STAGE_CAPS = None


class Hit(NamedTuple):
    t: jnp.ndarray       # (N,)
    n: jnp.ndarray       # (N,3) front-facing unit normal
    front: jnp.ndarray   # (N,) bool
    mat: jnp.ndarray     # (N,) int32
    ok: jnp.ndarray      # (N,) bool


def intersect(scene: Scene, o, d, t_cap=None) -> Hit:
    """Nearest hit across all primitive types (branchless combine).

    t_cap (optional, (N,)): per-ray search window. Pass 0 for dead lanes —
    every primitive test fails instantly and, crucially, packets whose 128
    rays are all dead exit BVH traversal after one node visit.
    """
    n_rays = o.shape[0]
    if t_cap is None:
        t_best = jnp.full(n_rays, INF, jnp.float32)
    else:
        t_best = jnp.asarray(t_cap, jnp.float32)
    n_best = jnp.zeros((n_rays, 3), jnp.float32).at[:, 1].set(1.0)
    m_best = jnp.zeros(n_rays, jnp.int32)

    ts, ns, ms, hs = geometry.hit_spheres(
        o, d, scene.sph_c, scene.sph_r, scene.sph_mat, t_best
    )
    closer = hs & (ts < t_best)
    t_best = jnp.where(closer, ts, t_best)
    n_best = jnp.where(closer[:, None], ns, n_best)
    m_best = jnp.where(closer, ms, m_best)

    tp, np_, mp, hp = geometry.hit_planes(
        o, d, scene.pln_n, scene.pln_k, scene.pln_mat, t_best
    )
    closer = hp & (tp < t_best)
    t_best = jnp.where(closer, tp, t_best)
    n_best = jnp.where(closer[:, None], np_, n_best)
    m_best = jnp.where(closer, mp, m_best)

    gid = None
    if scene.pk_nodes is not None or scene.pk8_nodes is not None:
        tt, nt, mt, ht, gid = packet_nearest_tri(scene, o, d, t_best)
    elif scene.has_bvh:
        tt, tri = bvh_nearest_tri(scene, o, d, t_best)
        ht = tri >= 0
        tri_c = jnp.maximum(tri, 0)
        nt = linalg.normalize(
            jnp.cross(scene.tri_e1[tri_c], scene.tri_e2[tri_c])
        )
        mt = scene.tri_mat[tri_c]
        if scene.tri_src is not None:
            gid = jnp.where(ht, scene.tri_src[tri_c], -1)
    else:
        tt, nt, mt, ht, tri = geometry.hit_triangles_brute(
            o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat,
            t_best,
        )
        if scene.tri_src is not None:
            gid = jnp.where(ht, scene.tri_src[tri], -1)
    closer = ht & (tt < t_best)
    t_best = jnp.where(closer, tt, t_best)
    n_best = jnp.where(closer[:, None], nt, n_best)
    m_best = jnp.where(closer, mt, m_best)

    hit = t_best < INF
    front = jnp.sum(d * n_best, axis=-1) < 0.0
    n_face = jnp.where(front[:, None], n_best, -n_best)

    if scene.tri_shn is not None and gid is not None:
        # A.5 optional vn path: interpolate the winner triangle's vertex
        # normals at the hit's barycentrics. One (N,32) row gather supplies
        # normals AND the triangle (v0,e1,e2) for the u,v recompute; the
        # geometric normal still decides front/back (and the interpolated
        # normal is flipped to the same hemisphere).
        use = closer & (gid >= 0)
        row = scene.tri_shn[jnp.maximum(gid, 0)]          # (N,32)
        p = o + t_best[:, None] * d
        tvec = p - row[:, 9:12]
        e1, e2 = row[:, 12:15], row[:, 15:18]
        nrm = jnp.cross(e1, e2)
        den = jnp.sum(nrm * nrm, axis=-1)
        # below the smallest normal f32 -> 1.0, whether or not the backend
        # flushes denormals (XLA's CPU runtime does, its GPU backend does
        # not); cpu_ref applies the same threshold
        den = jnp.where(den >= jnp.finfo(jnp.float32).tiny, den, 1.0)
        u = jnp.sum(jnp.cross(tvec, e2) * nrm, axis=-1) / den
        v = jnp.sum(jnp.cross(e1, tvec) * nrm, axis=-1) / den
        u = jnp.clip(u, 0.0, 1.0)
        v = jnp.clip(v, 0.0, 1.0 - u)
        ns = (
            (1.0 - u - v)[:, None] * row[:, 0:3]
            + u[:, None] * row[:, 3:6]
            + v[:, None] * row[:, 6:9]
        )
        ns = linalg.normalize(ns)
        ns = jnp.where(front[:, None], ns, -ns)
        n_face = jnp.where(use[:, None], ns, n_face)

    return Hit(t=t_best, n=n_face, front=front, mat=m_best, ok=hit)


def sky(scene: Scene, d):
    """Gradient background (A.7); zero endpoints => black (Cornell)."""
    t = 0.5 * (d[:, 1] + 1.0)
    return scene.sky_a[None, :] + t[:, None] * (
        scene.sky_b[None, :] - scene.sky_a[None, :]
    )


def _part1by2(x):
    """Spread 7 bits of x to every 3rd bit (for 21-bit Morton interleave)."""
    x = x & 0x7F
    x = (x | (x << 8)) & 0x0700F
    x = (x | (x << 4)) & 0x430C3
    x = (x | (x << 2)) & 0x49249
    return x


def ray_coherence_key(scene: Scene, o, d, alive, variant: str = "octant"):
    """Sort key grouping rays into traversal-coherent packets.

    variant="octant": direction octant (3 bits, MAJOR) then Morton cell of
    the origin within the BVH root bbox (21 bits). It lost on bounce
    rays on the previous accelerator — same-octant
    grouping pulls origins from across the whole batch's world footprint,
    widening the per-packet node-set union vs the tile order it replaced.

    variant="morton": origin Morton cell MAJOR (21 bits), octant minor —
    keeps packets origin-local (like tile order) and only subsorts by
    direction within a cell.

    Dead rays sort to the end (their packets exit traversal instantly)."""
    root = scene.pk_nodes[0]
    if root.dtype == jnp.uint32:
        # bf16-packed rows (bvh.pack_nodes_bf16): slots 0-2 hold the
        # left child's (lo | hi<<16) pairs — exact f32 expansion; the
        # key only needs approximate root bounds anyway
        lo = jax.lax.bitcast_convert_type(
            root[0:3] << jnp.uint32(16), jnp.float32)
        hi = jax.lax.bitcast_convert_type(
            root[0:3] & jnp.uint32(0xFFFF0000), jnp.float32)
    else:
        lo, hi = root[0:3], root[3:6]
    span = jnp.maximum(hi - lo, 1e-6)
    q = jnp.clip((o - lo[None, :]) / span[None, :], 0.0, 0.999)
    cell = (q * 128.0).astype(jnp.int32)                     # 7 bits/axis
    morton = (
        _part1by2(cell[:, 0])
        | (_part1by2(cell[:, 1]) << 1)
        | (_part1by2(cell[:, 2]) << 2)
    )
    octant = (
        (d[:, 0] < 0).astype(jnp.int32)
        + 2 * (d[:, 1] < 0).astype(jnp.int32)
        + 4 * (d[:, 2] < 0).astype(jnp.int32)
    )
    if variant == "morton":
        key = (morton << 3) | octant
    else:
        key = (octant << 21) | morton
    return jnp.where(alive, key, jnp.int32(0x7FFFFFFF))


@partial(jax.jit, static_argnames=("max_depth", "rr_start", "resort",
                                   "bounce0", "want_state", "stage_max"))
def trace(scene: Scene, o, d, keys, max_depth: int,
          rr_start: Optional[int] = None, resort: bool = False,
          valid=None, bounce0: int = 0, atten0=None, rad0=None,
          want_state: bool = False, stage_max: Optional[int] = None):
    """Path-trace N rays over bounces [bounce0, max_depth).

    Returns (radiance (N,3) in the INPUT ray order, rays_cast ()) where
    rays_cast counts every live ray entering a bounce (the Mrays metric
    numerator, SURVEY.md §5 "Metrics"). With want_state=True returns a
    third element: the SoA ray state ``(o, d, atten, alive, keys)`` at
    loop exit, full width in input order — the general bounce-span
    handoff contract (used by span-resume callers).

    bounce0/atten0/rad0 resume a span: the bounce counter is ABSOLUTE
    (RNG draws and Russian roulette key off it), so splitting a path at
    any bounce and resuming with the handed-off state is bit-identical
    to the unsplit trace — per-ray accumulation chains are unchanged and
    dead lanes only ever add exact 0.0.

    valid (optional (N,) bool): rays born dead (e.g. sharding pad lanes,
    mesh.py) — never traced, never counted.

    stage_max overrides BOUNCE_STAGE_MAX for this call (the merged-tail
    span enters much wider than its live set, so it runs a deeper
    compaction ladder).

    resort: re-sort rays inside the loop each bounce by (liveness,
    direction octant) — all on-device — so traversal packets stay
    direction-coherent after diffuse bounces. Off by default: on the
    previous accelerator the per-bounce permute (row gathers over ~7
    arrays) cost more than the traversal coherence won back; kept as an
    option for scenes with deeper trees where the trade flips.
    """
    resort = resort and scene.pk_nodes is not None
    assert not (resort and want_state), "state handoff assumes fixed order"

    def cond(c):
        bounce, _, _, _, _, _, alive, _, _ = c
        return (bounce < max_depth) & jnp.any(alive)

    def body(c):
        bounce, o, d, atten, rad, slot, alive, ks, nrays = c
        nrays = nrays + jnp.sum(alive, dtype=jnp.int32)

        h = intersect(scene, o, d, t_cap=jnp.where(alive, INF, 0.0))
        live_hit = alive & h.ok
        live_miss = alive & ~h.ok

        rad = rad + jnp.where(live_miss[:, None], atten * sky(scene, d), 0.0)
        mp = scene.mat_packed[h.mat]               # ONE (N,16) param gather
        mtype = jax.lax.bitcast_convert_type(mp[:, 0], jnp.int32)
        rad = rad + jnp.where(live_hit[:, None], atten * mp[:, 4:7], 0.0)

        draws = rng.bounce_draws(ks, bounce)
        p = o + h.t[:, None] * d
        new_d, att, s_alive = materials.scatter(
            d, h.n, h.front, mtype, mp[:, 1:4], mp[:, 7], mp[:, 8], draws,
        )
        atten = jnp.where(live_hit[:, None], atten * att, atten)
        alive = live_hit & s_alive
        o = jnp.where(live_hit[:, None], p, o)
        d = jnp.where(live_hit[:, None], new_d, d)

        if rr_start is not None:
            # A.8: from bounce >= rr_start survive with p = clamp(max(atten))
            p_surv = jnp.clip(jnp.max(atten, axis=-1), RR_CLAMP_LO, RR_CLAMP_HI)
            rr_on = (bounce >= rr_start) & alive
            survive = draws[4] < p_surv
            atten = jnp.where(
                (rr_on & survive)[:, None], atten / p_surv[:, None], atten
            )
            alive = alive & (~rr_on | survive)

        if resort:
            key = ray_coherence_key(scene, o, d, alive)
            order = jnp.argsort(key, stable=True)
            o, d, atten, rad = o[order], d[order], atten[order], rad[order]
            slot, alive, ks = slot[order], alive[order], ks[:, order]

        return bounce + 1, o, d, atten, rad, slot, alive, ks, nrays

    n = o.shape[0]
    init = (
        jnp.int32(bounce0),
        o,
        d,
        jnp.ones((n, 3), jnp.float32) if atten0 is None else atten0,
        jnp.zeros((n, 3), jnp.float32) if rad0 is None else rad0,
        jnp.arange(n, dtype=jnp.int32),
        jnp.ones(n, bool) if valid is None else valid,
        keys,
        jnp.int32(0),
    )

    # Tail compaction over BOUNCES, at packet granularity (same trick as
    # traverse.run_stages): every per-bounce op costs O(batch size) while
    # the live population decays, so once the count of packets with ANY
    # live ray fits the next capacity, gather those packets' rows into
    # half-size arrays and continue there. Rays never leave their packet
    # (traversal coherence preserved); `slot` carries original indices for
    # the final radiance scatter. Requires N to be packet-aligned.
    if want_state:
        # state handoff: plain while_loop, no ladder — the unwind would
        # have to merge EVERY carry back to full width; the caller's cut
        # spans the high-liveness fresh bounces where the packet ladder
        # rarely engages anyway (bounce-3 ray liveness ~15% but packet
        # any-liveness is far higher — compaction is a tail phenomenon).
        final = jax.lax.while_loop(cond, body, init)
        _, fo, fd, fatten, rad, _, falive, fks, nrays = final
        return rad, nrays, (fo, fd, fatten, falive, fks)

    staged = (n % PACKET_R == 0) and not resort

    def _gather(c, sel, cap):
        bounce, o, d, atten, rad, slot, alive, ks, nrays = c
        pk = o.shape[0] // PACKET_R

        def rows(a):
            return a.reshape(pk, -1)[sel].reshape(
                cap * PACKET_R, *a.shape[1:]
            )

        return (bounce, rows(o), rows(d), rows(atten), rows(rad),
                rows(slot), rows(alive),
                ks.reshape(3, pk, -1)[:, sel].reshape(3, cap * PACKET_R),
                nrays)

    def _run(c, caps):
        if not caps:
            return jax.lax.while_loop(cond, body, c)
        cap = caps[0]
        pk = c[1].shape[0] // PACKET_R
        if pk <= cap:
            return _run(c, caps[1:])

        def cond2(st):
            live_pk = jnp.sum(
                jnp.any(st[6].reshape(-1, PACKET_R), axis=-1),
                dtype=jnp.int32,
            )
            return cond(st) & (live_pk > cap)

        c = jax.lax.while_loop(cond2, body, c)
        pk_dead = ~jnp.any(c[6].reshape(-1, PACKET_R), axis=-1)
        sel = jnp.argsort(pk_dead.astype(jnp.int32), stable=True)[:cap]
        sub = _run(_gather(c, sel, cap), caps[1:])
        # Only rad (finalized radiance) and the scalars need to come back;
        # rad rows are scattered to original slots at the end via `slot`.
        return (sub[0], c[1], c[2], c[3],
                c[4].reshape(pk, -1).at[sel].set(
                    sub[4].reshape(cap, -1)
                ).reshape(-1, 3),
                c[5], c[6], c[7], sub[8])

    if staged:
        from .kernels.traverse import stage_caps
        n_pk = n // PACKET_R
        caps = (list(BOUNCE_STAGE_CAPS) if BOUNCE_STAGE_CAPS is not None
                else stage_caps(n_pk, floor=BOUNCE_STAGE_FLOOR,
                                max_stages=(BOUNCE_STAGE_MAX
                                            if stage_max is None
                                            else stage_max)))
        final = _run(init, caps)
        _, _, _, _, rad, _, _, _, nrays = final
        # rad is ALREADY in input order here: _run's unwind merges every
        # stage's sub-results back into the pre-compaction rows, so the
        # top-level slot is the identity, and no
        # `zeros.at[slot].set(rad)` scatter (which XLA cannot elide:
        # slot is a runtime value) is needed.
    else:
        _, _, _, _, rad, slot, _, _, nrays = jax.lax.while_loop(
            cond, body, init
        )
        if resort:
            rad = jnp.zeros_like(rad).at[slot].set(rad)
    return rad, nrays


# Decreed constants for config 1's "primary-ray render, Lambertian shading"
# (BASELINE config 1 names no light setup; fixed here and frozen by goldens).
PRIMARY_LIGHT_DIR = (0.57735027, 0.57735027, 0.57735027)
PRIMARY_AMBIENT = 0.25


@jax.jit
def shade_primary(scene: Scene, o, d):
    """Config 1: single-bounce Lambertian shading, no secondary rays.

    color = albedo * (ambient + (1-ambient) * max(0, n·L)) on hit, sky on
    miss, emission for emissive materials. Deterministic given the camera
    jitter; exercises layers L1–L11 without bounce physics (SURVEY.md §7 M0).
    """
    h = intersect(scene, o, d)
    light = jnp.asarray(PRIMARY_LIGHT_DIR, jnp.float32)
    ndotl = jnp.maximum(jnp.sum(h.n * light[None, :], axis=-1), 0.0)
    shade = PRIMARY_AMBIENT + (1.0 - PRIMARY_AMBIENT) * ndotl
    mp = scene.mat_packed[h.mat]
    lit = mp[:, 1:4] * shade[:, None] + mp[:, 4:7]
    return jnp.where(h.ok[:, None], lit, sky(scene, d)), jnp.int32(o.shape[0])
