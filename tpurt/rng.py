"""Deterministic counter-based RNG streams (SURVEY.md Appendix A.10, v2).

Replaces the reference's per-thread PRNG (SURVEY.md §2 "RNG"): every draw
is a pure function of ``(seed, pixel_index, sample_index, stream)`` via
Threefry-2x32 (20 rounds, Salmon et al. 2011), so renders are
bit-reproducible for a fixed seed regardless of tiling, sample chunking,
device count, wavefront queue order, or checkpoint/resume.

**Spec v2 — why not jax.random:** the original spec (SURVEY A.10) chained
``jax.random.fold_in``/``uniform`` over per-ray key pairs. On the
accelerator this was designed for, that layout — (N, 2) key arrays and
vmapped per-key uniform calls — dominated the megakernel bounce loop
(minor-dim-2 arrays were lane-padded, and each draw re-runs the fold
chain). This module
implements threefry directly over scalar-SoA (N,) uint32 arrays: perfectly
lane-tiled, fully fused by XLA, and implemented twice — jnp here, NumPy
twins below — with bit-identical integer semantics, which makes the
cpu_ref oracle's streams exactly the device streams with NO jax dependency
in the oracle.

Stream derivation (normative):

  streams            = (pixel_id, sample_id, seed) three uint32 (N,) rows
  pair c of stream s = threefry2x32(key=(seed, s + c), ctr=(pixel, sample))
  camera draws       = stream CAMERA_STREAM, 2 pairs -> (4, N) uniforms:
      [0], [1] : pixel-footprint AA jitter
      [2], [3] : thin-lens disk sample (bits unused at aperture 0; pair
                 c=0's bits are unchanged from the 1-pair v2 layout)
  bounce b draws     = stream BOUNCE_BASE + 4*b, 3 pairs -> (6, N):
      [0], [1] : direction draws (unit-vector z/phi; shared by materials)
      [2]      : radius draw for random-in-unit-sphere (metal fuzz)
      [3]      : dielectric reflect-vs-refract decision
      [4]      : Russian-roulette survival draw
      [5]      : reserved
  uniform from u32   = (word >> 8) * 2**-24   (exact f32 in [0, 1))

  (Draws are keyed per PAIR counter c, so trimming the pair count from 4
  to 3 — only 5 draws are consumed — left every consumed draw's bits
  unchanged; the stream-id stride stays 4 for compatibility.)

Sampling primitives are rejection-free closed forms:
  random_unit_vector(u0, u1): z = 2*u0 - 1, phi = 2*pi*u1
  random_in_unit_sphere(u0, u1, u2): random_unit_vector * cbrt(u2)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

NDRAWS = 6
CAMERA_STREAM = np.uint32(0x43414D00)   # 'CAM\0'
BOUNCE_BASE = np.uint32(0xB0000000)
_KS_PARITY = np.uint32(0x1BD11BDA)
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_U24 = np.float32(1.0 / (1 << 24))


def _threefry2x32(k0, k1, x0, x1, xp):
    """Threefry-2x32, 20 rounds. All args uint32 arrays (or scalars) under
    module xp (jnp or np); returns (y0, y1). Bit-identical across backends
    by integer semantics."""
    u32 = xp.uint32

    def rotl(v, r):
        return (v << u32(r)) | (v >> u32(32 - r))

    ks0 = k0
    ks1 = k1
    ks2 = k0 ^ k1 ^ _KS_PARITY
    x0 = (x0 + ks0).astype(u32)
    x1 = (x1 + ks1).astype(u32)
    ks = (ks0, ks1, ks2)
    for i in range(5):
        for r in _ROT[4 * (i % 2) : 4 * (i % 2) + 4]:
            x0 = (x0 + x1).astype(u32)
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]).astype(u32)
        x1 = (x1 + ks[(i + 2) % 3] + u32(i + 1)).astype(u32)
    return x0, x1


def _uniform(word, xp):
    return (word >> xp.uint32(8)).astype(xp.float32) * _U24


def _draw_pairs(streams, stream_id, n_pairs, xp):
    """streams: (3, N) uint32 [pixel, sample, seed]; returns
    (2 * n_pairs, N) f32 uniforms in [0, 1)."""
    pix, smp, seed = streams[0], streams[1], streams[2]
    stream_id = xp.asarray(stream_id).astype(xp.uint32)  # scalar or (N,)
    out = []
    for c in range(n_pairs):
        y0, y1 = _threefry2x32(
            seed, (stream_id + xp.uint32(c)).astype(xp.uint32),
            pix, smp, xp,
        )
        out.append(_uniform(y0, xp))
        out.append(_uniform(y1, xp))
    return xp.stack(out)


# -- jnp API (device tracers) ------------------------------------------------

def make_streams(seed, pixel_ids, sample_ids):
    """(N,) pixel/sample ids + scalar seed -> (3, N) uint32 stream state."""
    pix = jnp.asarray(pixel_ids).astype(jnp.uint32)
    smp = jnp.asarray(sample_ids).astype(jnp.uint32)
    seed_row = jnp.full_like(pix, jnp.uint32(seed)) if np.isscalar(seed) \
        else jnp.broadcast_to(jnp.asarray(seed, jnp.uint32), pix.shape)
    return jnp.stack([pix, smp, seed_row])


def camera_draws(streams):
    """(3, N) streams -> (4, N) uniforms: AA jitter + lens-disk sample."""
    return _draw_pairs(streams, CAMERA_STREAM, 2, jnp)


def bounce_draws(streams, bounce):
    """(3, N) streams, bounce scalar or (N,) -> (NDRAWS, N) uniforms.

    A per-ray bounce vector serves the persistent wavefront, where queue
    slots hold rays at different depths simultaneously."""
    sid = BOUNCE_BASE + jnp.uint32(4) * jnp.asarray(bounce).astype(jnp.uint32)
    return _draw_pairs(streams, sid, NDRAWS // 2, jnp)


def unit_vector_from(u0, u1):
    """Uniform direction on the unit sphere from two uniforms; returns
    component tuple (x, y, z) of (N,) arrays."""
    z = 2.0 * u0 - 1.0
    phi = (2.0 * np.pi) * u1
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return r * jnp.cos(phi), r * jnp.sin(phi), z


def in_unit_sphere_from(u0, u1, u2):
    """Uniform point in the unit ball; component tuple of (N,) arrays."""
    x, y, z = unit_vector_from(u0, u1)
    s = jnp.cbrt(u2)
    return x * s, y * s, z * s


# -- NumPy twins (the cpu_ref oracle) ----------------------------------------

def np_make_streams(seed, pixel_ids, sample_ids):
    pix = np.asarray(pixel_ids).astype(np.uint32)
    smp = np.asarray(sample_ids).astype(np.uint32)
    return np.stack([pix, smp, np.full_like(pix, np.uint32(seed))])


def np_camera_draws(seed, pixel_ids, sample_ids):
    with np.errstate(over="ignore"):
        return _draw_pairs(np_make_streams(seed, pixel_ids, sample_ids),
                           CAMERA_STREAM, 2, np)


def np_bounce_draws(seed, pixel_ids, sample_ids, bounce):
    sid = np.uint32(BOUNCE_BASE + np.uint32(4) * np.uint32(bounce))
    with np.errstate(over="ignore"):
        return _draw_pairs(np_make_streams(seed, pixel_ids, sample_ids),
                           sid, NDRAWS // 2, np)


def np_unit_vector_from(u0, u1):
    z = 2.0 * u0 - 1.0
    phi = (2.0 * np.pi) * u1
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=-1).astype(np.float32)


def np_in_unit_sphere_from(u0, u1, u2):
    return np_unit_vector_from(u0, u1) * np.cbrt(u2).astype(np.float32)[:, None]
