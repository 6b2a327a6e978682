"""Vec3 math over (..., 3) jnp arrays (SoA-friendly batched helpers).

Replaces the reference's C++ vec3/ray structs (SURVEY.md §1 L1, §2
"Vec/ray math"): instead of a scalar ``v3`` type threaded through recursive
calls, every function here maps over a whole batch of rays at once so XLA
lowers it to dense elementwise kernels.

Conventions (SURVEY.md Appendix A.1): right-handed, y-up, linear RGB f32.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-8


def dot(a, b):
    """Batched dot product over the last axis; keeps a trailing axis of 1 off."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def norm(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a, eps: float = 1e-12):
    """Unit-normalize; guarded so zero vectors don't produce NaNs."""
    n = jnp.sqrt(jnp.maximum(jnp.sum(a * a, axis=-1, keepdims=True), eps))
    return a / n


def reflect(v, n):
    """Mirror reflection of direction v about unit normal n (A.6 metal)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, eta_ratio):
    """Snell refraction of *unit* direction uv about unit normal n (A.6).

    eta_ratio = eta_incident / eta_transmitted, shape broadcastable to
    uv[..., 0]. Caller is responsible for the total-internal-reflection
    branch; when TIR would occur this returns a garbage (but finite) vector
    that the caller must select away.
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = eta_ratio[..., None] * (uv + cos_theta[..., None] * n)
    k = jnp.abs(1.0 - jnp.sum(r_out_perp * r_out_perp, axis=-1))
    r_out_parallel = -jnp.sqrt(k)[..., None] * n
    return r_out_perp + r_out_parallel


def lerp(a, b, t):
    return a + (b - a) * t
