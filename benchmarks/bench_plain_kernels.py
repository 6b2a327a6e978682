"""Device time per call of the plain jnp/lax versions of three hot steps.

Each step once had a hand-written kernel for the previous accelerator; on
the GPU the plain version is what XLA compiles and what runs. A future
hand-written GPU kernel for one of them has to beat these times:

  brute   geometry.hit_triangles_brute — c2-cornell's triangle path (no
          BVH), at its 128k-ray batch (render.BRUTE_RAY_BATCH)
  node    one phase-A node step of the packet traversal
          (traverse.node_fields + slab_any2) over c3-mesh's octant node
          table, at its 512k-ray batch (4096 packets)
  leaf    the drain's dense Möller–Trumbore phase (traverse.leaf_hits),
          one leaf row per packet, at the same batch
  loop    an empty step: what one iteration of the timing loop itself
          costs (its control flow and launch), to read the others against

Rays are the presets' own primary rays; node and leaf rows are drawn
uniformly from the scene's tables with a fixed seed.

    python benchmarks/bench_plain_kernels.py      # needs a GPU

How a step is timed: one jitted ``lax.fori_loop`` calls the step K times
back to back on the device. Each call's inputs are passed through a
select on the previous call's outputs that never fires, so XLA can
neither hoist the step out of the loop nor drop any of its outputs. The
time per call is (wall(K_HI) - wall(K_LO)) / (K_HI - K_LO): dispatch,
transfer and the final sync appear in both walls and cancel. Prints one
JSON line per step: median and quartiles over REPS such pairs.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPS = 20
K_LO, K_HI = 1, 101


def looped(step, feed, k: int):
    """jit of k back-to-back calls of step(*args); call i + 1 gets
    feed(args, out_i). Returns the last call's outputs."""
    import jax

    @jax.jit
    def run(*args):
        def body(_, carry):
            a, out = carry
            a = feed(a, out)
            return a, step(*a)

        return jax.lax.fori_loop(0, k - 1, body, (args, step(*args)))[1]

    return run


def per_call_ms(step, feed, args, reps: int = REPS) -> dict:
    import jax

    lo, hi = looped(step, feed, K_LO), looped(step, feed, K_HI)
    t0 = time.perf_counter()
    jax.block_until_ready((lo(*args), hi(*args)))
    first = time.perf_counter() - t0

    def wall(fn):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        return time.perf_counter() - t0

    per = [(wall(hi) - wall(lo)) / (K_HI - K_LO) for _ in range(reps)]
    q1, med, q3 = np.percentile(per, [25, 50, 75])
    return {"compile_and_first_s": first, "median_ms": med * 1e3,
            "q1_ms": q1 * 1e3, "q3_ms": q3 * 1e3, "reps": reps,
            "calls_per_rep": [K_LO, K_HI]}


def never(x):
    """A mask that is false for every output the steps produce (their
    t values, codes and ids are never below -1) but that XLA cannot fold."""
    return x < -1


def primary_rays(name: str, n: int, **overrides):
    """The first n primary rays of a preset, in the render's tile order."""
    import jax.numpy as jnp

    from tpurt import camera, config, render, rng

    cfg = config.PRESETS[name].replace(**overrides)
    scene, cam = config.build_scene(cfg)
    order = render.tile_order(cfg.width, cfg.height)
    pix = jnp.asarray(np.resize(order, n))
    keys = rng.make_streams(jnp.uint32(cfg.seed), pix,
                            jnp.zeros(n, jnp.int32))
    o, d = camera.generate_rays(cam, cfg.width, cfg.height, pix,
                                rng.camera_draws(keys))
    return scene.device(), o, d


def bench_brute(n: int, **overrides):
    """(info, step, feed, args) of c2-cornell's brute triangle test."""
    import jax.numpy as jnp

    from tpurt import geometry

    scene, o, d = primary_rays("c2-cornell", n, **overrides)
    args = (o, d, scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_mat,
            jnp.full(n, geometry.INF, jnp.float32))

    def feed(a, out):
        m = never(out[0])
        o, d, *tris, t_max = a
        return (jnp.where(m[:, None], d, o), jnp.where(m[:, None], o, d),
                *tris, jnp.where(m, out[0], t_max))

    info = {"rays": n, "triangles": int(scene.tri_v0.shape[0])}
    return info, geometry.hit_triangles_brute, feed, args


def packets(o, d):
    """(P, R) scalar-SoA origins, inverse directions and directions, all
    on the device (a host array would time its transfer too)."""
    import jax.numpy as jnp

    from tpurt.kernels import traverse

    p = o.shape[0] // traverse.PACKET_R

    def soa(a):
        return tuple(a[:, k].reshape(p, traverse.PACKET_R) for k in range(3))

    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    return p, soa(o), soa(inv), soa(d)


def node_step(nodes, nid, t_best, oxs, ixs):
    from tpurt.kernels import traverse

    rows, icol = traverse.node_fields(nodes, nid)
    m_l, m_r, skip = icol(12), icol(13), icol(14)
    code = traverse.slab_any2(rows, t_best, oxs, ixs,
                              ((m_l & 1) << 2) | ((m_r & 1) << 3))
    return code, m_l, m_r, skip


def bench_node(n: int, **overrides):
    """(info, step, feed, args) of one phase-A node step over c3-mesh."""
    import jax.numpy as jnp

    from tpurt.kernels import traverse

    scene, o, d = primary_rays("c3-mesh", n, **overrides)
    p, oxs, ixs, _ = packets(o, d)
    nodes = scene.pk_oct_nodes
    nid = jnp.asarray(np.random.default_rng(0).integers(
        0, nodes.shape[0], p), jnp.int32)
    t_best = jnp.full((p, traverse.PACKET_R), 3.0e38, jnp.float32)

    def feed(a, out):
        m = never(out[0])
        nodes, nid, t_best, oxs, ixs = a
        mr = m[:, None]
        return (nodes, jnp.where(m, out[3], nid),
                jnp.where(mr, 0.0, t_best),
                tuple(jnp.where(mr, x, y) for x, y in zip(ixs, oxs)), ixs)

    info = {"rays": n, "packets": p, "node_rows": int(nodes.shape[0])}
    return info, node_step, feed, (nodes, nid, t_best, oxs, ixs)


def bench_leaf(n: int, **overrides):
    """(info, step, feed, args) of the drain's dense leaf phase, one leaf
    row per packet of c3-mesh."""
    import jax.numpy as jnp

    from tpurt.kernels import traverse

    scene, o, d = primary_rays("c3-mesh", n, **overrides)
    p, oxs, _, dxs = packets(o, d)
    leaves = scene.pk_leaves
    rows = np.random.default_rng(1).integers(0, leaves.shape[0], p)
    tri = jnp.asarray(np.asarray(leaves)[rows])
    vrow = jnp.ones((p, 1), bool)
    t_best = jnp.full((p, traverse.PACKET_R), 3.0e38, jnp.float32)

    def feed(a, out):
        m = never(out[0])
        tri, vrow, ro, rd, t_best = a
        return (tri, vrow, tuple(jnp.where(m, y, x) for x, y in zip(ro, rd)),
                rd, jnp.where(m, out[0], t_best))

    info = {"rays": n, "packets": p, "leaf_rows": int(leaves.shape[0])}
    return info, traverse.leaf_hits, feed, (tri, vrow, oxs, dxs, t_best)


def bench_loop(n: int, **overrides):
    """(info, step, feed, args) of a step that does next to nothing."""
    import jax.numpy as jnp

    def feed(a, out):
        return (jnp.where(never(out), out, a[0]),)

    return {"elements": 1}, (lambda x: x + 1.0), feed, (jnp.zeros(1),)


def main() -> int:
    from tpurt import compile_cache, gpu, render

    device = gpu.require_gpu()
    card = "; ".join(gpu.nvidia_smi())
    compile_cache.enable()
    for name, bench, n in (("loop", bench_loop, 1),
                           ("brute", bench_brute, render.BRUTE_RAY_BATCH),
                           ("node", bench_node, 1 << 19),
                           ("leaf", bench_leaf, 1 << 19)):
        info, step, feed, args = bench(n)
        print(json.dumps({"step": name, "device": device, "card": card,
                          "timing": "device time per call, from K calls "
                                    "in one jitted fori_loop",
                          **info, **per_call_ms(step, feed, args)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
