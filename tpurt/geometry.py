"""Branchless batched primitive intersection (SURVEY.md §1 L3, A.3–A.5).

The reference's scalar ``sphere_hit``/``plane_hit``/``tri_hit`` functions
(SURVEY.md §2) become all-rays × all-primitives tests combined with
``jnp.where``/argmin — no divergent branches, so every lane stays
busy. Each ``hit_*`` returns the best hit *of that primitive type* for
every ray; ``nearest`` in trace.py combines types.

Spec anchors: sphere = half-b quadratic with a=1 (unit dirs), t-window
(T_MIN=1e-3, t_max) (A.3); plane n·x = k (A.4); triangle Möller–Trumbore
with determinant epsilon 1e-8, flat geometric normals (A.5).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import linalg

T_MIN = 1e-3
INF = jnp.float32(3.0e38)
TRI_EPS = 1e-8


def hit_spheres(o, d, centers, radii, mat_ids, t_max):
    """o,d: (N,3) unit dirs; centers (S,3), radii (S,). Returns per-ray best
    (t, normal(outward), mat_id, hit_mask).

    Layout note: the test runs over (S, N) arrays — primitive axis
    LEADING, ray axis minor. On the accelerator this was designed for,
    the naive (N, S, 3) broadcast padded both minor dims to its (8, 128)
    tile and multiplied memory traffic; componentwise (S, N) math is
    dense on any backend.
    """
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]            # (N,)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    cx = centers[:, 0][:, None]                       # (S,1)
    cy = centers[:, 1][:, None]
    cz = centers[:, 2][:, None]
    ocx = ox[None, :] - cx                            # (S,N)
    ocy = oy[None, :] - cy
    ocz = oz[None, :] - cz
    half_b = ocx * dx[None, :] + ocy * dy[None, :] + ocz * dz[None, :]
    c = ocx * ocx + ocy * ocy + ocz * ocz - (radii ** 2)[:, None]
    disc = half_b * half_b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -half_b - sq
    t1 = -half_b + sq
    t = jnp.where(t0 > T_MIN, t0, t1)
    ok = (disc > 0.0) & (t > T_MIN) & (t < t_max[None, :])
    t = jnp.where(ok, t, INF)                         # (S,N)

    i = jnp.argmin(t, axis=0)                         # (N,)
    tb = jnp.min(t, axis=0)
    hit = tb < INF
    # winner attributes via one-hot select over the (small, static) S axis
    # — no per-ray gathers on the hot path
    onehot = jnp.arange(t.shape[0])[:, None] == i[None, :]   # (S,N)
    ohf = onehot.astype(jnp.float32)
    cbx = jnp.sum(cx * ohf, axis=0)
    cby = jnp.sum(cy * ohf, axis=0)
    cbz = jnp.sum(cz * ohf, axis=0)
    rb = jnp.sum(radii[:, None] * ohf, axis=0)
    rb = jnp.where(rb == 0.0, 1.0, rb)
    mb = jnp.sum(jnp.where(onehot, mat_ids[:, None], 0), axis=0)
    nx = (ox + tb * dx - cbx) / rb
    ny = (oy + tb * dy - cby) / rb
    nz = (oz + tb * dz - cbz) / rb
    return tb, jnp.stack([nx, ny, nz], axis=-1), mb, hit


def hit_planes(o, d, normals, offsets, mat_ids, t_max):
    """Infinite planes n·x = k with unit normals (A.4). Same (P, N)
    componentwise layout rationale as hit_spheres."""
    nx = normals[:, 0][:, None]                       # (P,1)
    ny = normals[:, 1][:, None]
    nz = normals[:, 2][:, None]
    denom = (d[:, 0][None, :] * nx + d[:, 1][None, :] * ny
             + d[:, 2][None, :] * nz)                 # (P,N)
    num = offsets[:, None] - (o[:, 0][None, :] * nx + o[:, 1][None, :] * ny
                              + o[:, 2][None, :] * nz)
    safe = jnp.where(jnp.abs(denom) > 1e-8, denom, 1.0)
    t = num / safe
    ok = (jnp.abs(denom) > 1e-8) & (t > T_MIN) & (t < t_max[None, :])
    t = jnp.where(ok, t, INF)

    i = jnp.argmin(t, axis=0)
    tb = jnp.min(t, axis=0)
    hit = tb < INF
    onehot = jnp.arange(t.shape[0])[:, None] == i[None, :]
    ohf = onehot.astype(jnp.float32)
    nbx = jnp.sum(nx * ohf, axis=0)
    nby = jnp.sum(ny * ohf, axis=0)
    nbz = jnp.sum(nz * ohf, axis=0)
    mb = jnp.sum(jnp.where(onehot, mat_ids[:, None], 0), axis=0)
    return tb, jnp.stack([nbx, nby, nbz], axis=-1), mb, hit


def moller_trumbore(o, d, v0, e1, e2, t_max):
    """Batched Möller–Trumbore (A.5). All inputs broadcast over leading dims;
    o,d: (..., 3) vs v0,e1,e2: (..., 3). Returns (t, valid)."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    nondegen = jnp.abs(det) > TRI_EPS
    inv = 1.0 / jnp.where(nondegen, det, 1.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv
    t = jnp.sum(e2 * qvec, axis=-1) * inv
    valid = (
        nondegen
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > T_MIN)
        & (t < t_max)
    )
    return jnp.where(valid, t, INF), valid


def hit_triangles_brute(o, d, v0, e1, e2, mat_ids, t_max):
    """All-pairs triangle test — used for small scenes / as the BVH oracle.

    Componentwise over (T, N) — triangle axis leading, rays minor — for
    the same layout reason as hit_spheres.
    """
    ox, oy, oz = o[:, 0][None, :], o[:, 1][None, :], o[:, 2][None, :]
    dx, dy, dz = d[:, 0][None, :], d[:, 1][None, :], d[:, 2][None, :]

    def tc(a, k):
        return a[:, k][:, None]                        # (T,1)

    v0x, v0y, v0z = tc(v0, 0), tc(v0, 1), tc(v0, 2)
    e1x, e1y, e1z = tc(e1, 0), tc(e1, 1), tc(e1, 2)
    e2x, e2y, e2z = tc(e2, 0), tc(e2, 1), tc(e2, 2)

    # pvec = d x e2
    pvx = dy * e2z - dz * e2y                          # (T,N)
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    nondegen = jnp.abs(det) > TRI_EPS
    inv = 1.0 / jnp.where(nondegen, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    valid = (
        nondegen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > T_MIN) & (t < t_max[None, :])
    )
    t = jnp.where(valid, t, INF)                       # (T,N)

    i = jnp.argmin(t, axis=0)                          # (N,)
    tb = jnp.min(t, axis=0)
    hit = tb < INF
    n = linalg.normalize(jnp.cross(e1[i], e2[i]))
    return tb, n, mat_ids[i], hit, i.astype(jnp.int32)


def slab_test(o, d_inv, lo, hi, t_min, t_max):
    """Branchless AABB slab test; d_inv precomputed (guarded) reciprocal.

    o,d_inv: (..., 3); lo,hi: (..., 3); t_min/t_max: (...,). Returns bool.
    """
    t0 = (lo - o) * d_inv
    t1 = (hi - o) * d_inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tn <= tf) & (tf > t_min) & (tn < t_max)


def safe_inv_dir(d, eps: float = 1e-12):
    """Reciprocal direction with zero components nudged off the singularity."""
    mag = jnp.maximum(jnp.abs(d), eps)
    return jnp.where(d < 0, -1.0, 1.0) / mag
