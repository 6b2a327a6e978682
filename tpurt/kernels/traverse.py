"""BVH traversal (SURVEY.md §2 "BVH traversal" ->
tpurt/kernels/traverse.py).

Two device implementations of nearest-triangle search over the flattened
skip-link BVH:

  * packet_nearest_tri — the production path: one traversal cursor per
    128-ray packet over the PacketBVH layout (see its docstring for the
    design rationale).
  * bvh_nearest_tri — the straightforward per-ray walk over the binary
    arrays; far slower on the previous accelerator, where a row gather
    cost a fixed few ns per row, but trivially correct, kept as the
    differential-testing oracle for the packet path.

Both are pure jnp/lax programs that XLA compiles for the GPU as they
stand. The design was tuned on the previous accelerator, where a
traversal round was bound by its serial chain of small dependent ops
(gather -> slab -> lane reduce -> select), not by dense flops. Whether
that holds on the H100, and whether one hand-written kernel per batch
(Pallas on the Triton route, or CUDA via jax.ffi) beats it, is ROADMAP
A3/A4; packet_nearest_tri is the one to beat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import geometry
from ..bvh import LEAF_N
from ..geometry import INF, T_MIN
from ..scene import Scene


def bvh_nearest_tri(scene: Scene, o, d, t_max):
    """Stackless skip-link traversal; returns (t, tri_index|-1)."""
    n_rays = o.shape[0]
    d_inv = geometry.safe_inv_dir(d)
    leaf_off = jnp.arange(LEAF_N, dtype=jnp.int32)

    def cond(state):
        node, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, t_best, tri_best = state
        active = node >= 0
        nid = jnp.maximum(node, 0)
        lo = scene.bvh_lo[nid]
        hi = scene.bvh_hi[nid]
        box = geometry.slab_test(o, d_inv, lo, hi, T_MIN, t_best) & active

        cnt = scene.bvh_count[nid]
        is_leaf = cnt > 0
        do_leaf = box & is_leaf

        idx = jnp.where(do_leaf, scene.bvh_first[nid], 0)
        idx = idx[:, None] + leaf_off[None, :]            # (N, LEAF_N)
        tv0 = scene.tri_v0[idx]
        te1 = scene.tri_e1[idx]
        te2 = scene.tri_e2[idx]
        t, valid = geometry.moller_trumbore(
            o[:, None, :], d[:, None, :], tv0, te1, te2, t_best[:, None]
        )
        t = jnp.where(valid & do_leaf[:, None], t, INF)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        better = tj < t_best
        t_best = jnp.where(better, tj, t_best)
        tri_best = jnp.where(
            better, jnp.take_along_axis(idx, j[:, None], axis=-1)[:, 0],
            tri_best,
        )

        nxt = jnp.where(box & ~is_leaf, node + 1, scene.bvh_skip[nid])
        node = jnp.where(active, nxt, node)
        return node, t_best, tri_best

    init = (
        jnp.zeros(n_rays, jnp.int32),
        jnp.asarray(t_max, jnp.float32),
        jnp.full(n_rays, -1, jnp.int32),
    )
    _, t_best, tri_best = jax.lax.while_loop(cond, body, init)
    return t_best, tri_best


PACKET_R = 128  # rays per packet: one traversal cursor per 128 rays
# The schedule constants below were tuned end to end on the previous
# accelerator and keep those values; none is yet measured on the H100
# (ROADMAP A5).
# node steps per traversal round at full width; the narrow stages use
# ADV_MID/ADV_TAIL (wide stages are step-volume-bound, narrow tail stages
# round-count-bound, where more steps per round means fewer rounds).
ADV_STEPS = 6
ADV_MID = 8     # stages with pp <= DRAIN2_MAX
ADV_TAIL = 8    # stages with pp <= DRAIN4_MAX
# node steps per round over the WIDE (8-ary) layout: each step covers ~3
# binary levels, so fewer steps sustain the same leaf-enqueue rate.
ADV_STEPS_WIDE = 3
# node steps per round over the 4-ary layout (each step = 2 binary levels)
ADV_STEPS_WIDE4 = 5
# Production switch for the wide layout — see the selection comment in
# packet_nearest_tri (it measured slower under the current round regime).
WIDE_ENABLE = False
# Octant-ordered traversal (bvh.PacketBVH.oct_nodes): each packet walks
# the re-flatten whose child order is front-to-back for its majority
# direction-sign octant, tightening t_best earlier so the slab test
# culls far subtrees — it shrinks the per-packet footprint union itself
# rather than rescheduling it (fewer rounds and fewer node visits at
# unchanged widths). Scene builds ship the 8 tables only when this is set
# (scene.py, same contract as WIDE_ENABLE).
OCT_ENABLE = True
MC_K = 8        # subtree cursors per packet (multi-cursor traversal)
# Multi-cursor only pays for traversals that START narrow (deep-bounce
# tail batches): at full width it lost — the packet-round volume rose
# more than the round count fell (un-synced cursors lose cross-subtree
# occlusion pruning). Narrow entries remain latency-chain-bound, where
# splitting the walk across MC_K overlapping gather chains wins.
MC_PACKETS = 64
# Banked-leaf ring size per cursor (leaf enqueues bank here between
# drains; a cursor stalls only on ring overflow).
BANK_S = 4
# Batched-drain widths per stage: DRAIN_N = (tail, mid, full) ring
# entries drained per round as ONE dense phase, for pp <= DRAIN4_MAX /
# pp <= DRAIN2_MAX / larger (see the phase-B comment).
DRAIN4_MAX = 64
DRAIN2_MAX = 256
DRAIN_N = (4, 2, 1)


# Stage-ladder generator for the tail compactions (run_stages here and
# the bounce stages in trace.py): capacities p//2 .. p//2^max_stages.
# Deeper ladders (an absolute 8-packet floor) and ratio-4 ladders both
# lost on the previous accelerator: each extra stage costs one more
# while_loop, compaction gather and cond chain. Not yet measured on the
# H100.
STAGE_RATIO = 2
STAGE_FLOOR = 8
STAGE_MAX = 6            # deepest traversal stage: p // 2^6


def stage_caps(p: int, ratio: int = None, floor: int = None,
               max_stages: int = None) -> list:
    """Capacities p//r, p//r^2, ... (at most max_stages, none below
    floor)."""
    ratio = STAGE_RATIO if ratio is None else ratio
    floor = STAGE_FLOOR if floor is None else floor
    max_stages = STAGE_MAX if max_stages is None else max_stages
    caps = []
    c = p // ratio
    while c >= floor and len(caps) < max_stages:
        caps.append(c)
        c //= ratio
    return caps


def node_fields(nodes, nid, packed: bool = False):
    """Gather the (P, 16) node rows of cursors nid; returns (rows,
    icol) where icol(c) reads meta column c as int32 (packed rows keep the
    metas at slots 6-8 instead of 12-14)."""
    # promise_in_bounds: nid is clamped by the caller already, and the
    # default gather mode's clamp was a standalone kernel per adv step.
    # Meta columns come back as (P,) f32 VALUES and are bitcast at the
    # use sites, where a (P,) bitcast is free inside any consumer fusion.
    rows = nodes.at[nid].get(mode="promise_in_bounds")   # (P, 16)

    def icol(c):
        # packed rows carry the metas at slots 6-8 instead of 12-14
        return jax.lax.bitcast_convert_type(
            rows[:, c - 6 if packed else c], jnp.int32)

    return rows, icol


def slab_any2(rows, t_best, oxs, ixs, extra_bits=None, packed: bool = False):
    """Per-lane slab test of BOTH child boxes, reduced over lanes in
    ONE fused reduction (two separate anys were two serialized links).

    The two hit masks are packed into ONE (P, R) int32 hitcode (bit0 =
    left, bit1 = right) and reduced with a single bitwise-or lane
    reduction to (P,); stacking to (P, 2, R) and slicing back out cost
    two extra kernels per adv step. The bit tests on the reduced (P,)
    code are free — they fuse into the step epilogue.

    extra_bits: optional (P,) int32 constant-per-packet bits OR'd
    into every lane before the reduce, so they pass through to the
    output code for free — adv_step rides the two leaf flags (bits
    2-3) through here, which deleted the standalone per-step `eq`
    kernel the flags otherwise cost."""
    # Column access is a KEEPDIM slice rows[:, c:c+1] (a (P,1) operand
    # broadcast along the ray axis inside the fusion), NOT
    # rows[:, c, None]: the squeeze-to-(P,) form made XLA materialize
    # all 12 columns through a separate relayout kernel per adv step.
    code = None
    for bit, off in ((1, 0), (2, 6)):
        tn = jnp.full(t_best.shape, jnp.float32(T_MIN))
        tf = t_best
        for k in range(3):
            if packed:
                # (lo | hi<<16) bf16 pair per u32 slot; shift/mask +
                # bitcast expand EXACTLY to f32 and fuse into the
                # slab math — 6 column extracts instead of 12
                cu = rows[:, off // 2 + k:off // 2 + k + 1]
                lo = jax.lax.bitcast_convert_type(
                    cu << jnp.uint32(16), jnp.float32)
                hi = jax.lax.bitcast_convert_type(
                    cu & jnp.uint32(0xFFFF0000), jnp.float32)
                t0 = (lo - oxs[k]) * ixs[k]
                t1 = (hi - oxs[k]) * ixs[k]
            else:
                t0 = (rows[:, off + k:off + k + 1] - oxs[k]) * ixs[k]
                t1 = (rows[:, off + k + 3:off + k + 4] - oxs[k]) * ixs[k]
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        c = jnp.where(tn <= tf, jnp.int32(bit), jnp.int32(0))
        code = c if code is None else code | c
    if extra_bits is not None:
        code = code | extra_bits[:, None]
    code = jax.lax.reduce(code, jnp.int32(0), jax.lax.bitwise_or,
                          (1,))                          # (P,)
    return code


def leaf_hits(tri, vrow, ro, rd, t_best):
    """Dense Möller–Trumbore of each packet's gathered leaf rows against
    its PACKET_R rays — the drain's phase B.

    tri: (P*D, LEAF_F*LN) leaf rows, D per packet in pop order; vrow:
    (P, D) bool row validity; ro, rd: 3-tuples of (P, R) ray origin and
    direction components; t_best: (P, R) current windows. Returns (tj,
    better, nx, ny, nz, mat, gid), each (P, R): the nearest valid t, the
    mask of rays it improves, and that winner's unit normal, material
    and source triangle id. argmin takes the first minimum along the
    (D, LN) pop order, so ties resolve as D sequential drains would.
    """
    from ..bvh import PACKET_LEAF_N as LN

    pp, D = vrow.shape
    dl = D * LN

    def tc(k):                                  # (P, D*LN, 1)
        return tri[:, k * LN:(k + 1) * LN].reshape(
            pp, dl)[:, :, None]

    v0x, v0y, v0z = tc(0), tc(1), tc(2)
    e1x, e1y, e1z = tc(3), tc(4), tc(5)
    e2x, e2y, e2z = tc(6), tc(7), tc(8)
    matb = jax.lax.bitcast_convert_type(
        tri[:, 9 * LN:10 * LN].reshape(pp, dl), jnp.int32)
    gidb = jax.lax.bitcast_convert_type(
        tri[:, 10 * LN:11 * LN].reshape(pp, dl), jnp.int32)
    pend3 = jnp.broadcast_to(
        vrow[:, :, None], (pp, D, LN)).reshape(pp, dl)[:, :, None]

    rox, roy, roz = (c[:, None, :] for c in ro)
    rdx, rdy, rdz = (c[:, None, :] for c in rd)

    # pvec = d x e2
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz     # (P, D*LN, R)
    nondegen = jnp.abs(det) > geometry.TRI_EPS
    invd = 1.0 / jnp.where(nondegen, det, 1.0)
    # tvec = o - v0
    tvx, tvy, tvz = rox - v0x, roy - v0y, roz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * invd
    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (rdx * qvx + rdy * qvy + rdz * qvz) * invd
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * invd
    valid = (
        nondegen & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > T_MIN) & (t < t_best[:, None, :])
        & pend3
    )
    t = jnp.where(valid, t, INF)
    tj = jnp.min(t, axis=1)                     # (P, R)
    j = jnp.argmin(t, axis=1)
    better = tj < t_best

    # per-leaf-tri geometric normals (P, D*LN), winner-select
    # via one-hot
    gnx = (e1y[:, :, 0] * e2z[:, :, 0]
           - e1z[:, :, 0] * e2y[:, :, 0])
    gny = (e1z[:, :, 0] * e2x[:, :, 0]
           - e1x[:, :, 0] * e2z[:, :, 0])
    gnz = (e1x[:, :, 0] * e2y[:, :, 0]
           - e1y[:, :, 0] * e2x[:, :, 0])
    glen = jnp.sqrt(jnp.maximum(gnx**2 + gny**2 + gnz**2,
                                1e-24))
    gnx, gny, gnz = gnx / glen, gny / glen, gnz / glen

    onehot = jnp.arange(dl)[None, :, None] == j[:, None, :]
    ohf = onehot.astype(jnp.float32)
    w_nx = jnp.sum(gnx[:, :, None] * ohf, axis=1)
    w_ny = jnp.sum(gny[:, :, None] * ohf, axis=1)
    w_nz = jnp.sum(gnz[:, :, None] * ohf, axis=1)
    # The int payloads ride the SAME f32 one-hot sweep as
    # the normals — exact (mat/gid values < 2^24; non-winner
    # lanes contribute x*0.0 = exact 0.0, the winner rides
    # through the f32 roundtrip losslessly): XLA splits reduction
    # fusions by dtype, so an s32 where+sum pair would be a second
    # full (P, dl, R) sweep.
    w_m = jnp.sum(matb.astype(jnp.float32)[:, :, None] * ohf,
                  axis=1).astype(jnp.int32)
    w_g = jnp.sum(gidb.astype(jnp.float32)[:, :, None] * ohf,
                  axis=1).astype(jnp.int32)

    return tj, better, w_nx, w_ny, w_nz, w_m, w_g


def packet_nearest_tri(scene: Scene, o, d, t_max, with_counters=False):
    """Packet traversal over the child-in-parent layout (bvh.PacketBVH).

    Design rationale (SURVEY.md §7 hard part 1): on the accelerator this
    was designed for, an XLA row gather cost a fixed few ns per row
    nearly independent of row width, so a per-ray walk was
    gather-latency-bound. Here ONE traversal cursor serves a packet of
    PACKET_R rays — classic packet traversal on a vector machine. Whether
    a per-ray walk in one kernel wins on the H100 is ROADMAP A4:

      * one (P, 16) node-row gather per visited INNER node tests BOTH
        children's boxes (P = N/128 packets); missed subtrees are never
        entered, and leaf children enqueue with no node visit at all
        (the CIP layout, bvh.PacketBVH);
      * the packet enters a subtree if ANY member ray hits its box
        (conservative union); per-ray t windows still prune;
      * leaf visits gather one row holding all PACKET_LEAF_N triangles
        (40 bytes each) and intersect them against all 128 rays as dense
        (P, LN, R) elementwise math — no per-ray memory access at all.

    Round structure: each round advances every active cursor ADV_STEPS
    nodes, banking leaf enqueues into a BANK_S-deep ring per cursor (a
    cursor stalls only on ring overflow), then dense-intersects every
    pending packet's ring head — several ring entries per round at tail
    widths (see the phase-B comment: rounds are gated by the straggler
    packet's leaf backlog, so the tail drains multiple entries per round
    where dense math is cheap). A round has a hard LATENCY floor — dozens
    of kernel launches per round, and the in-round gathers form a serial
    dependence chain — so the tail is round-count-bound, not
    width-bound. Mitigations:

      * staged tail compaction (run_stages): rounds cost O(live packet
        set), so still-active packets are gathered into half-size arrays
        as the set shrinks (cheap (P,128)-row gathers; per-ray (N,)-row
        permutes cost far more and are NOT used);
      * multi-cursor traversal (mc_wide) for traversals that START
        narrow (<= MC_PACKETS packets — deep-bounce tail batches): each
        packet runs MC_K cursors, one per precomputed subtree row span
        (bvh cut), merged exactly once at the end — see mc_wide's
        docstring and the MC_PACKETS comment for the trade.

    Returns per-ray (t, normal, mat, found, gid) for the N input
    rays; gid is the original triangle index of the winner (-1 if none) —
    it feeds the optional vn shading-normal interpolation (A.5).
    """
    n = o.shape[0]
    pad = (-n) % PACKET_R
    if pad:
        far = jnp.asarray([0.0, 0.0, 3.0e37], jnp.float32)
        o = jnp.concatenate([o, jnp.broadcast_to(far, (pad, 3))])
        d = jnp.concatenate(
            [d, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                                 (pad, 3))]
        )
        t_max = jnp.concatenate([t_max, jnp.zeros(pad, jnp.float32)])
    p = o.shape[0] // PACKET_R

    # Fully scalar SoA: every hot array is (P, R) or (P, LN, R) with the
    # ray axis R=128 minor — a trailing xyz dim of 3 was padded to the
    # previous accelerator's 128-lane tile and multiplied memory traffic.
    ox, oy, oz = (o[:, k].reshape(p, PACKET_R) for k in range(3))
    dx, dy, dz = (d[:, k].reshape(p, PACKET_R) for k in range(3))

    def inv(c):
        mag = jnp.maximum(jnp.abs(c), 1e-12)
        return jnp.where(c < 0, -1.0, 1.0) / mag

    ix, iy, iz = inv(dx), inv(dy), inv(dz)

    # Wide-fanout (8-ary) layout (bvh.PacketBVH8): one 64-f32 row gather
    # tests EIGHT subtrees, shortening the straggler walk ~3x — but per
    # round it tests MORE boxes (3x8 vs 8x2), and under the walk-gated
    # round regime that box volume lost. Gated off in production until a
    # regime change flips the trade.
    wide = WIDE_ENABLE and scene.pk8_nodes is not None
    nodes = scene.pk8_nodes if wide else scene.pk_nodes  # (Mw,64)|(Mi,16)
    leaves = scene.pk8_leaves if wide else scene.pk_leaves
    cut = scene.pk8_cut if wide else scene.pk_cut
    n_total = nodes.shape[0]
    use_oct = (OCT_ENABLE and not wide
               and getattr(scene, "pk_oct_nodes", None) is not None)
    if use_oct:
        # 8 octant re-flattens stacked as one (8*Mi, 16) gather array;
        # cursors carry ABSOLUTE rows (octant base + relative row; the
        # base is rederived per step by floor-dividing end, not carried)
        # so the loop carry is unchanged. Leaf rows are shared across
        # octants.
        nodes = scene.pk_oct_nodes
        cut = scene.pk_oct_cut                     # (8, 8, 2) per octant
    use_mc = cut is not None
    adv_steps = ADV_STEPS if not wide else (
        ADV_STEPS_WIDE if nodes.shape[1] == 64 else ADV_STEPS_WIDE4)
    # bf16-packed node rows (bvh.PK_BF16_PACK / pack_nodes_bf16): u32
    # slots 0-5 hold (lo | hi<<16) bf16 pairs, 6-8 the metas. Expansion
    # back to f32 is EXACT and boxes were rounded outward at build time,
    # so the slab stays a conservative cull on f32 arithmetic — images
    # byte-identical, while each adv step extracts 6 box columns
    # instead of 12. Off by default.
    packed = (not wide) and nodes.dtype == jnp.uint32

    def slab_anyw(rows, t_best, oxs, ixs, fan, extra_bits=None):
        """Per-lane slab test of all `fan` child boxes of a wide row
        (component-major: lo_c at slot c*F+k, hi_c at 3F+c*F+k for child
        k), packed into ONE (P, R) int32 hitmask (bit k = child k) and
        reduced with a single bitwise-or lane reduction — the same
        single-link + single-output-code discipline as slab_any2, so the
        bit tests downstream fuse into the step epilogue. extra_bits
        (bits fan..) ride through the reduce for free."""
        code = None
        for k in range(fan):
            tn = jnp.full(t_best.shape, jnp.float32(T_MIN))
            tf = t_best
            for c in range(3):
                # keepdim slices for the same relayout-kernel reason as
                # slab_any2
                i0, i1 = c * fan + k, (3 + c) * fan + k
                t0 = (rows[:, i0:i0 + 1] - oxs[c]) * ixs[c]
                t1 = (rows[:, i1:i1 + 1] - oxs[c]) * ixs[c]
                tn = jnp.maximum(tn, jnp.minimum(t0, t1))
                tf = jnp.minimum(tf, jnp.maximum(t0, t1))
            c_k = jnp.where(tn <= tf, jnp.int32(1 << k), jnp.int32(0))
            code = c_k if code is None else code | c_k
        if extra_bits is not None:
            code = code | extra_bits[:, None]
        return jax.lax.reduce(code, jnp.int32(0), jax.lax.bitwise_or,
                              (1,))                          # (P,)

    def make_outer():
        """Round body over the (possibly virtual, see mc_wide) packet
        axis."""

        def outer(st):
            (node, end, b0, b1, b2, b3, qh, qt, sox, soy, soz,
             sdx, sdy, sdz, six, siy, siz,
             t_best, nx, ny, nz, m_best, g_best, found,
             it_outer, it_adv, it_pp, it_pend) = st
            banks = [b0, b1, b2, b3]
            pp = node.shape[0]
            oxs = (sox, soy, soz)
            ixs = (six, siy, siz)
            if with_counters:
                it_outer = it_outer + 1
                # array-rounds: every round costs O(pp) in gathers, slab
                # flops AND the dense leaf phase regardless of liveness —
                # it_pp is the Σpp that the component cost model scales by.
                it_pp = it_pp + pp

            # Phase A: ADV_STEPS node steps. Each cursor banks pending
            # leaf rows into a BANK_S-deep ring (qh/qt head-tail counters)
            # and keeps advancing; it stalls only when a visit's enqueues
            # would overflow the ring (the visit is then retried after
            # phase B drains a slot).
            def adv_step(nd, banks, qh, qt):
                cnt = qt - qh
                act = (nd >= 0) & (cnt < BANK_S)   # >= 1 slot free
                rows, icol = node_fields(nodes, jnp.maximum(nd, 0), packed)
                m_l, m_r, skip = icol(12), icol(13), icol(14)
                code = slab_any2(rows, t_best, oxs, ixs,
                                 ((m_l & 1) << 2) | ((m_r & 1) << 3),
                                 packed)
                hit_l = ((code & 1) != 0) & act
                hit_r = ((code & 2) != 0) & act
                leaf_l = (code & 4) != 0
                leaf_r = (code & 8) != 0
                e_l = hit_l & leaf_l
                e_r = hit_r & leaf_r
                # overflow: two enqueues with only one free slot
                ok = act & ~(e_l & e_r & (cnt == BANK_S - 1))
                go_l = hit_l & ~leaf_l
                go_r = hit_r & ~leaf_r
                nxt = jnp.where(go_l, m_l >> 1,
                                jnp.where(go_r, m_r >> 1, skip))
                if use_oct:
                    # metas/skip are table-relative; cursors are absolute
                    # (base rederived from end — not carried). end is
                    # base + Mi at full width but base + e for a
                    # multi-cursor sub-span [s, e), so floor-divide:
                    # end - 1 lands inside the octant's Mi-row block for
                    # any non-empty span. A relative skip of -1 lands at
                    # base - 1 < base: dead. (Dead cursors may derive a
                    # garbage base; their nxt is never committed.)
                    base = ((end - 1) // n_total) * n_total
                    nxt = nxt + base
                    nxt = jnp.where((nxt < base) | (nxt >= end), -1, nxt)
                else:
                    nxt = jnp.where((nxt < 0) | (nxt >= end), -1, nxt)
                first = jnp.where(e_l, m_l >> 1, m_r >> 1)  # first enqueue
                second = m_r >> 1                           # when e_l & e_r
                do1 = ok & (e_l | e_r)
                do2 = ok & e_l & e_r
                t0 = qt % BANK_S
                t1 = (qt + 1) % BANK_S
                banks = [
                    jnp.where(do2 & (t1 == k), second,
                              jnp.where(do1 & (t0 == k), first, bk))
                    for k, bk in enumerate(banks)
                ]
                qt = qt + do1.astype(jnp.int32) + do2.astype(jnp.int32)
                nd = jnp.where(ok, nxt, nd)
                return nd, banks, qh, qt

            def adv_step_wide(nd, banks, qh, qt):
                """One step over a wide layout (bvh.PacketBVH8, fanout 8
                or 4 — inferred from the row width). A visit tests all F
                child boxes from ONE row gather; every hit LEAF child
                folds into a single ring entry (leaf_base << 8) | hitmask
                — drains pop one set bit per drain — and the cursor
                descends to the FIRST hit inner child (lowest row; later
                hit siblings arrive via the DFS skip chain exactly as in
                the binary layout)."""
                fan = nodes.shape[1] // 8
                cnt = qt - qh
                act = (nd >= 0) & (cnt < BANK_S)   # >= 1 slot free
                rows = nodes.at[jnp.maximum(nd, 0)].get(
                    mode="promise_in_bounds")                  # (P, 8F)
                metas = jax.lax.bitcast_convert_type(
                    rows[:, 6 * fan:7 * fan], jnp.int32)       # (P, F)
                skip = jax.lax.bitcast_convert_type(
                    rows[:, 7 * fan], jnp.int32)
                base = jax.lax.bitcast_convert_type(
                    rows[:, 7 * fan + 1], jnp.int32)
                hcode = slab_anyw(rows, t_best, oxs, ixs, fan)  # (P,)
                hits = (hcode[:, None]
                        & jnp.left_shift(1, jnp.arange(fan))[None]) != 0
                # meta < 0 marks an empty slot (see bvh.PacketBVH8: an
                # inverted box does NOT fail the slab test)
                ehit = hits & (metas >= 0) & act[:, None]
                is_leaf = (metas & 1) == 1
                leaf_hit = ehit & is_leaf
                inner_hit = ehit & ~is_leaf
                rank = metas >> 1       # leaf rank / inner row, by kind
                leafmask = jnp.sum(
                    jnp.where(leaf_hit, jnp.left_shift(1, rank), 0),
                    axis=1)
                nxt = skip
                for k in range(fan - 1, -1, -1):  # first hit inner child
                    nxt = jnp.where(inner_hit[:, k], rank[:, k], nxt)
                nxt = jnp.where((nxt < 0) | (nxt >= end), -1, nxt)
                entry = jnp.left_shift(base, 8) | leafmask
                do1 = act & (leafmask > 0)
                t0 = qt % BANK_S
                banks = [jnp.where(do1 & (t0 == k), entry, bk)
                         for k, bk in enumerate(banks)]
                qt = qt + do1.astype(jnp.int32)
                nd = jnp.where(act, nxt, nd)
                return nd, banks, qh, qt

            step_fn = adv_step_wide if wide else adv_step
            adv_here = adv_steps if wide else (
                ADV_TAIL if pp <= DRAIN4_MAX else
                ADV_MID if pp <= DRAIN2_MAX else adv_steps)
            for _ in range(adv_here):
                node, banks, qh, qt = step_fn(node, banks, qh, qt)
            if with_counters:
                it_adv = it_adv + adv_here

            # Phase B: dense leaf intersection, draining ring heads.
            # Pending-packet compaction (gather pending packets into a
            # cap-sized block before the dense math) lost on the previous
            # accelerator — the cap turns into a drain-rate limit and the
            # round count more than doubles (rounds are gated by the
            # STRAGGLER packet's leaf backlog, not by node-chain length).
            # So every pending packet drains every round, and multiple
            # ring entries drain as ONE BATCHED dense phase over
            # (P, D*LN, R): D sequential drain chains would pay D serial
            # chains of links for the same dense flops, so the leaf-gated
            # round count divides by D at ~constant round cost.
            n_drains = DRAIN_N[0] if pp <= DRAIN4_MAX else (
                DRAIN_N[1] if pp <= DRAIN2_MAX else DRAIN_N[2])

            def drain_batch(D, banks, qh, qt, t_best, nx, ny, nz,
                            m_best, g_best, found, it_pend):
                """Pop up to D leaf rows per packet and intersect them in
                one dense (P, D*LN, R) phase. Winner order is identical
                to D sequential single drains: rows keep pop order on the
                flattened axis and argmin takes the first minimum, so
                ties resolve exactly as before (goldens unaffected)."""

                def head_at(q):
                    m = q % BANK_S
                    return jnp.where(
                        m == 0, banks[0],
                        jnp.where(m == 1, banks[1],
                                  jnp.where(m == 2, banks[2], banks[3])))

                rows_l, valid_l = [], []
                if wide:
                    # entry = (leaf_base << 8) | hitmask: walk D pops
                    # through masks and, when one empties, on to the next
                    # ring entry. All elementwise -> one fused kernel.
                    c_qh = qh
                    cur = head_at(c_qh)
                    cur_mask = cur & 0xFF
                    for _ in range(D):
                        has = (c_qh < qt) & (cur_mask != 0)
                        low = cur_mask & -cur_mask
                        j = jax.lax.population_count(low - 1)
                        rows_l.append(jnp.where(
                            has,
                            jax.lax.shift_right_logical(cur, 8) + j, 0))
                        valid_l.append(has)
                        cur_mask = cur_mask & (cur_mask - 1)
                        adv = has & (cur_mask == 0)
                        c_qh = c_qh + adv
                        nxt = head_at(c_qh)
                        cur = jnp.where(adv, nxt, cur)
                        cur_mask = jnp.where(adv, nxt & 0xFF, cur_mask)
                    # write the partially-consumed head entry back
                    more = c_qh < qt
                    wb = (jax.lax.shift_left(
                        jax.lax.shift_right_logical(cur, 8), 8) | cur_mask)
                    hm2 = c_qh % BANK_S
                    banks = [jnp.where(more & (hm2 == k), wb, bk)
                             for k, bk in enumerate(banks)]
                    qh = c_qh
                else:
                    cnt = qt - qh
                    for i in range(D):
                        rows_l.append(jnp.where(i < cnt,
                                                head_at(qh + i), 0))
                        valid_l.append(i < cnt)
                    qh = qh + jnp.minimum(cnt, D)
                row_mat = jnp.stack(rows_l, axis=1)          # (P, D)
                vrow = jnp.stack(valid_l, axis=1)            # (P, D)
                if with_counters:
                    # real row-drains this round (dense work not wasted)
                    it_pend = it_pend + jnp.sum(vrow, dtype=jnp.int32)

                # Flat (pp*D, LEAF_F*LN) gather + 2D column-block slices
                # (leaf_hits): gathering (pp, D, 384) and slicing the 4D
                # reshape tri[:, :, k] made XLA emit a relayout copy of
                # the whole gather plus one retile copy per component.
                # Row-major reshape (pp*D, LN) -> (pp, D*LN) preserves the
                # (D, LN) drain-major order, so winner ties resolve
                # identically.
                tri = leaves.at[row_mat.reshape(pp * D)].get(
                    mode="promise_in_bounds")        # (pp*D, LEAF_F*LN)

                tj, better, w_nx, w_ny, w_nz, w_m, w_g = leaf_hits(
                    tri, vrow, (sox, soy, soz), (sdx, sdy, sdz), t_best)

                t_best = jnp.where(better, tj, t_best)
                nx = jnp.where(better, w_nx, nx)
                ny = jnp.where(better, w_ny, ny)
                nz = jnp.where(better, w_nz, nz)
                m_best = jnp.where(better, w_m, m_best)
                g_best = jnp.where(better, w_g, g_best)
                found = found | better
                return (banks, qh, qt, t_best, nx, ny, nz,
                        m_best, g_best, found, it_pend)

            (banks, qh, qt, t_best, nx, ny, nz, m_best, g_best,
             found, it_pend) = drain_batch(
                n_drains, banks, qh, qt, t_best, nx, ny, nz,
                m_best, g_best, found, it_pend)

            return (node, end, banks[0], banks[1], banks[2], banks[3],
                    qh, qt, sox, soy, soz, sdx, sdy, sdz,
                    six, siy, siz,
                    t_best, nx, ny, nz, m_best, g_best, found,
                    it_outer, it_adv, it_pp, it_pend)

        return outer

    outer = make_outer()

    def cond(st):
        return jnp.any((st[0] >= 0) | (st[7] > st[6]))

    stage_log: list = []   # [(array_width, rounds_cum, pp_cum)] — only
    # appended under with_counters; diffs of consecutive entries give each
    # stage's round count and Σpp at its array width.

    def run_stages(state, caps):
        """Tail compaction: traversal rounds cost O(live packet set), but a
        while_loop's shapes are fixed — so run the loop in STAGES. Each
        stage loops until the active-packet count fits the next capacity,
        then gathers the still-active packets' rows (cheap (P,128)-row
        gathers) into half-size arrays and recurses; results scatter back
        on return. The long tail of straggler packets — which otherwise
        gates hundreds of full-size rounds — finishes on 1/8-size arrays."""
        if not caps:
            st = jax.lax.while_loop(cond, outer, state)
            if with_counters:
                stage_log.append((st[0].shape[0], st[24], st[26]))
            return st
        cap = caps[0]
        if state[0].shape[0] <= cap:
            return run_stages(state, caps[1:])

        def cond2(st):
            act = (st[0] >= 0) | (st[7] > st[6])
            return jnp.any(act) & (jnp.sum(act) > cap)

        state = jax.lax.while_loop(cond2, outer, state)
        if with_counters:
            stage_log.append((state[0].shape[0], state[24], state[26]))
        act = (state[0] >= 0) | (state[7] > state[6])
        order = jnp.argsort(
            jnp.where(act, 0, 1).astype(jnp.int32), stable=True
        )
        sel = order[:cap]
        sub = tuple(a if a.ndim == 0 else a[sel] for a in state)
        sub = run_stages(sub, caps[1:])
        out = []
        for full, s in zip(state, sub):
            out.append(s if full.ndim == 0 else full.at[sel].set(s))
        return tuple(out)

    def mc_wide(st):
        """Multi-cursor traversal: every packet becomes MC_K virtual
        packets, one per precomputed subtree row span (bvh cut), each
        pruning with its OWN t window; the K results merge ONCE at the
        end (argmin over cursors per ray). The virtual-cursor axis
        stage-compacts like ordinary packets.

        Rationale (measured on the previous accelerator): a traversal
        round's cost was dominated by the serial dependence chain of small
        ops (gather -> slab -> lane-any -> select), so narrow-entry
        traversals are round-latency-bound and splitting the walk across
        MC_K overlapping gather chains wins. At FULL width the same split
        lost (see the MC_PACKETS comment), so this engages only for
        narrow entries; the final merge is exact either way.
        """
        (node, end, b0, b1, b2, b3, qh, qt,
         sox, soy, soz, sdx, sdy, sdz, six, siy, siz,
         t_best, nx, ny, nz, m_best, g_best, found,
         it_outer, it_adv, it_pp, it_pend) = st
        cp = node.shape[0]
        # closes over `cut` — the (MC_K, 2) row-span table of whichever
        # layout (binary or wide) this traversal is running on

        def t8(a):
            return jnp.tile(a, (MC_K, 1))

        if use_oct:
            # per-packet octant spans: cut is (8, MC_K, 2) and cursors
            # are absolute — rebuild the k-major (K*cp,) layout with the
            # packet's base (= end - Mi) added to non-empty spans
            base_p = end - n_total                       # (cp,)
            co = cut[base_p // n_total]                  # (cp, MC_K, 2)
            rel0 = co[:, :, 0].T                         # (MC_K, cp)
            node_v = jnp.where(rel0 < 0, -1,
                               rel0 + base_p[None, :]).reshape(-1)
            end_v = (jnp.maximum(co[:, :, 1].T, 0)
                     + base_p[None, :]).reshape(-1)
        else:
            node_v = jnp.repeat(cut[:, 0], cp)           # (K*cp,)
            node_v = jnp.where(node_v < 0, -1, node_v)
            end_v = jnp.repeat(jnp.maximum(cut[:, 1], 0), cp)
        vp = MC_K * cp
        neg = jnp.full(vp, -1, jnp.int32)
        ziv = jnp.zeros(vp, jnp.int32)
        stv = (node_v, end_v, neg, neg, neg, neg, ziv, ziv,
               t8(sox), t8(soy), t8(soz), t8(sdx), t8(sdy), t8(sdz),
               t8(six), t8(siy), t8(siz),
               t8(t_best), t8(nx), t8(ny), t8(nz), t8(m_best), t8(g_best),
               t8(found), it_outer, it_adv, it_pp, it_pend)
        stv = run_stages(stv, stage_caps(vp))

        # exact merge: per ray, the cursor with the nearest hit wins
        def blk(a):
            return a.reshape(MC_K, cp, PACKET_R)

        tb = blk(stv[17])
        am = jnp.argmin(tb, axis=0)                     # (cp, R)
        oh = jnp.arange(MC_K)[:, None, None] == am[None]
        ohf = oh.astype(jnp.float32)

        def fsel(a):
            return jnp.sum(blk(a) * ohf, axis=0)

        def isel(a):
            return jnp.sum(jnp.where(oh, blk(a), 0), axis=0)

        out = [jnp.full(cp, -1, jnp.int32), end, b0, b1, b2, b3, qh, qt,
               sox, soy, soz, sdx, sdy, sdz, six, siy, siz,
               jnp.min(tb, axis=0),
               fsel(stv[18]), fsel(stv[19]), fsel(stv[20]),
               isel(stv[21]), isel(stv[22]),
               jnp.any(blk(stv[23]), axis=0)]
        out += list(stv[24:28])
        return tuple(out)

    zero = jnp.zeros((p, PACKET_R), jnp.float32)
    neg1 = jnp.full(p, -1, jnp.int32)
    zi = jnp.zeros(p, jnp.int32)
    if use_oct:
        # majority direction-sign octant per packet (bit a = most rays
        # have d[a] < 0); any choice is exact — the order only decides
        # which child the packet visits first. The vote counts LIVE
        # lanes only (t_max > 0; trace.intersect's dead-lane contract):
        # deep-bounce packets are mostly dead lanes whose stale
        # directions would otherwise swamp the vote. Ties and all-dead
        # packets resolve to the positive octant (bit clear), which at
        # full liveness is bit-identical to an unweighted > R/2 vote.
        tm2 = t_max.reshape(p, PACKET_R)
        live = (tm2 > 0).astype(jnp.int32)
        n_live = jnp.sum(live, axis=1)
        base0 = jnp.int32(0)
        for b, dc in enumerate((dx, dy, dz)):
            neg = jnp.sum((dc < 0).astype(jnp.int32) * live, axis=1)
            maj = (2 * neg > n_live).astype(jnp.int32)
            base0 = base0 | (maj << b)
        base0 = base0 * n_total
    else:
        base0 = zi
    init = (
        base0,
        base0 + n_total,
        neg1, neg1, neg1, neg1, zi, zi,
        ox, oy, oz, dx, dy, dz, ix, iy, iz,
        t_max.reshape(p, PACKET_R),
        zero, zero, zero,
        jnp.zeros((p, PACKET_R), jnp.int32),
        jnp.full((p, PACKET_R), -1, jnp.int32),
        jnp.zeros((p, PACKET_R), bool),
        jnp.int32(0),
        jnp.int32(0),
        jnp.int32(0),
        jnp.int32(0),
    )
    if use_mc and p <= MC_PACKETS:
        final = mc_wide(init)
    else:
        final = run_stages(init, stage_caps(p))
    t_best, nx, ny, nz, m_best, g_best, found = final[17:24]
    n_best = jnp.stack(
        [nx.reshape(-1)[:n], ny.reshape(-1)[:n], nz.reshape(-1)[:n]], axis=-1
    )
    out = (t_best.reshape(-1)[:n], n_best,
           m_best.reshape(-1)[:n], found.reshape(-1)[:n],
           g_best.reshape(-1)[:n])
    if with_counters:
        # (rounds, adv steps, Σ array-packets over rounds, Σ pending,
        #  stage log [(width, rounds_cum, pp_cum)])
        return out + tuple(final[24:28]) + (tuple(stage_log),)
    return out
