"""Branchless material scatter (SURVEY.md §1 L5, Appendix A.6).

The reference switches on material type per ray — the canonical divergence
point in a path tracer (SURVEY.md §3.1 "DIVERGENCE"). Here every ray
computes all three candidate scatter directions from the *same* per-ray
draw slots (rng.py layout) and a 3-way ``jnp.where`` selects by material id,
so no lane ever diverges. Cost: ~3x the scatter arithmetic, which is noise
next to traversal; benefit: zero lane masking and an RNG stream that is
independent of material (helping cpu_ref parity).

Spec (A.6):
  lambertian: dir = n + random_unit_vector(); fall back to n if near-zero.
  metal:      dir = reflect(unit_in, n) + fuzz * random_in_unit_sphere();
              absorbed when dir·n <= 0.
  dielectric: Snell with Schlick reflectance r0 + (1-r0)(1-cos)^5 vs a
              uniform draw; attenuation (1,1,1).
  emissive (A.7 extension): terminates the path (emission itself is added
              by the tracer before scatter).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import linalg, rng
from .scene import DIELECTRIC, EMISSIVE, METAL


def scatter(d, n, front, mtype, albedo, fuzz, ior, draws):
    """Batched scatter for N rays.

    d: (N,3) incoming unit dirs; n: (N,3) front-facing unit normals;
    front: (N,) bool (ray hit the outward side); mtype/albedo/fuzz/ior:
    per-ray gathered material params; draws: (NDRAWS, N) uniforms.

    Returns (new_dir (N,3) unit, attenuation (N,3), alive (N,) bool).
    """
    u0, u1, u2, u3 = draws[0], draws[1], draws[2], draws[3]
    ux, uy, uz = rng.unit_vector_from(u0, u1)           # shared direction draw
    unit = jnp.stack([ux, uy, uz], axis=-1)
    in_sphere = unit * jnp.cbrt(u2)[:, None]

    # lambertian
    lam_d = n + unit
    degenerate = jnp.sum(lam_d * lam_d, axis=-1) < 1e-12
    lam_d = jnp.where(degenerate[:, None], n, lam_d)

    # metal
    refl = linalg.reflect(d, n)
    met_d = refl + fuzz[:, None] * in_sphere
    met_alive = jnp.sum(met_d * n, axis=-1) > 0.0

    # dielectric
    eta = jnp.where(front, 1.0 / ior, ior)
    cos_t = jnp.minimum(jnp.sum(-d * n, axis=-1), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot_refract = eta * sin_t > 1.0
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    choose_reflect = cannot_refract | (reflectance > u3)
    refr = linalg.refract(d, n, eta)
    die_d = jnp.where(choose_reflect[:, None], refl, refr)

    # 3-way select (EMISSIVE direction is irrelevant — path terminates)
    new_d = jnp.where(
        (mtype == METAL)[:, None],
        met_d,
        jnp.where((mtype == DIELECTRIC)[:, None], die_d, lam_d),
    )
    new_d = linalg.normalize(new_d)

    atten = jnp.where((mtype == DIELECTRIC)[:, None],
                      jnp.ones_like(albedo), albedo)
    atten = jnp.where((mtype == EMISSIVE)[:, None],
                      jnp.zeros_like(albedo), atten)

    alive = jnp.where(mtype == METAL, met_alive, True)
    alive = alive & (mtype != EMISSIVE)
    return new_d, atten, alive
