"""Host-side BVH builder -> flattened, skip-linked node arrays (SURVEY §1 L4).

The reference builds a pointer-based node tree and traverses it with a
recursive descent + stack per ray (SURVEY.md §2 "BVH build"/"BVH traversal").
On a vector machine a per-lane stack means scattered per-lane memory
updates, so instead
the tree is flattened in depth-first order with *skip links* (escape
indices): traversal keeps a single int32 node cursor per ray and never
pushes/pops (SURVEY.md §7 M2 "rope/escape-index truly stackless").

For node i in DFS order:
  * inner node entered & box hit  -> next node is i + 1 (its left child);
  * leaf node entered & box hit   -> intersect its LEAF_N-padded triangle
    run, then continue at skip[i];
  * box missed                    -> continue at skip[i];
  * skip == -1                    -> traversal done.

Build policy (Appendix A.11): sort triangle centroids on the widest axis of
the centroid bounds, median split, leaf <= LEAF_N tris. Triangles are
permuted so each leaf's run is contiguous and padded to LEAF_N with a
degenerate (never-hit) triangle, letting the traversal loop intersect a
fixed-shape (N, LEAF_N) block every leaf visit.

Build runs once per scene on the host in NumPy (off the hot path,
SURVEY.md §3.5); the arrays live in HBM for the device traversal loop.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np

LEAF_N = 4
SAH_BINS = 16


def _sah_partition(idx: np.ndarray, tlo, thi,
                   centroid) -> tuple[np.ndarray, np.ndarray]:
    """Binned-SAH split (A.11 'SAH optional later' — enabled: measured
    fewer node visits than median split on blobby meshes). Falls back to
    the widest-axis median when every centroid lands in one bin.

    This NumPy implementation is the REFERENCE; the production path is
    the native C++ twin (tpurt/native/sah.cpp, selected per build by
    _partitioner below — this version was 12.7 s of a 16.6 s
    blob-subdiv-6 scene build). The port is bit-exact by construction
    and pinned against this implementation by tests/test_native_sah.py;
    no g++ / TPURT_NATIVE=0 falls back here."""
    c = centroid[idx]
    cb_lo = c.min(axis=0)
    cb_hi = c.max(axis=0)
    ext = cb_hi - cb_lo

    best_cost = np.inf
    best = None  # (axis, bin_edge)
    for axis in range(3):
        if ext[axis] < 1e-12:
            continue
        which = np.clip(
            ((c[:, axis] - cb_lo[axis]) / ext[axis] * SAH_BINS).astype(
                np.int64
            ),
            0, SAH_BINS - 1,
        )
        counts = np.bincount(which, minlength=SAH_BINS)
        # per-bin bounds over triangle bboxes
        blo = np.full((SAH_BINS, 3), np.inf, np.float64)
        bhi = np.full((SAH_BINS, 3), -np.inf, np.float64)
        np.minimum.at(blo, which, tlo[idx])
        np.maximum.at(bhi, which, thi[idx])
        # prefix/suffix accumulations
        plo = np.minimum.accumulate(blo, axis=0)
        phi = np.maximum.accumulate(bhi, axis=0)
        slo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        shi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        pcnt = np.cumsum(counts)

        def area(lo, hi):
            e = np.maximum(hi - lo, 0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        nl = pcnt[:-1]
        nr = idx.size - nl
        cost = area(plo[:-1], phi[:-1]) * nl + area(slo[1:], shi[1:]) * nr
        cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
        k = int(np.argmin(cost))
        if cost[k] < best_cost:
            best_cost = cost[k]
            best = (axis, which, k)

    if best is None:
        # all centroids coincide: arbitrary halves
        half = idx.size // 2
        return idx[:half], idx[half:], 0
    axis, which, k = best
    left = idx[which <= k]
    right = idx[which > k]
    if left.size == 0 or right.size == 0:  # degenerate; median fallback
        axis = int(np.argmax(ext))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        half = idx.size // 2
        return order[:half], order[half:], axis
    return left, right, axis


def _partitioner(tlo, thi, centroid):
    """Per-build SAH split function: the prebound native partitioner
    when available, else the NumPy reference."""
    from . import native

    part = native.make_partitioner(tlo, thi, centroid, SAH_BINS)
    if part is not None:
        return part
    return lambda idx: _sah_partition(idx, tlo, thi, centroid)


class BVH(NamedTuple):
    """Flattened skip-linked tree. All arrays device-ready (f32/i32)."""

    lo: np.ndarray       # (M,3) node bbox min
    hi: np.ndarray       # (M,3) node bbox max
    skip: np.ndarray     # (M,)  DFS escape index, -1 terminates
    first: np.ndarray    # (M,)  first padded-triangle index (leaves)
    count: np.ndarray    # (M,)  leaf triangle count, 0 for inner nodes
    # Leaf-order triangle soup, padded to LEAF_N per leaf with degenerates:
    tri_v0: np.ndarray   # (Tp,3)
    tri_e1: np.ndarray   # (Tp,3)
    tri_e2: np.ndarray   # (Tp,3)
    tri_mat: np.ndarray  # (Tp,) int32
    tri_src: np.ndarray  # (Tp,) int32 original triangle index, -1 = padding


def build(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, mat: np.ndarray,
          leaf_n: int = LEAF_N) -> BVH:
    """Median-split BVH over a triangle soup; returns flattened arrays."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    mat = np.asarray(mat, np.int32)
    ntri = v0.shape[0]
    assert ntri > 0, "BVH over empty triangle soup"

    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tlo + thi) * 0.5

    lo_l: list[np.ndarray] = []
    hi_l: list[np.ndarray] = []
    skip_l: list[int] = []
    first_l: list[int] = []
    count_l: list[int] = []
    leaf_runs: list[np.ndarray] = []  # original-index runs, leaf order
    pad_cursor = 0

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))

    _split = _partitioner(tlo, thi, centroid)

    def rec(idx: np.ndarray) -> int:
        """Emit the subtree over triangles idx in DFS order; return root id.

        Node bounds: leaves reduce over their (<= leaf_n) triangles;
        inner nodes take the elementwise union of their children —
        bit-identical to reducing over idx (min/max are exact under any
        grouping) and O(M) instead of O(n log n) gathers."""
        nonlocal pad_cursor
        node_id = len(skip_l)
        lo_l.append(None)
        hi_l.append(None)
        skip_l.append(0)
        if idx.size <= leaf_n:
            lo_l[node_id] = tlo[idx].min(axis=0)
            hi_l[node_id] = thi[idx].max(axis=0)
            first_l.append(pad_cursor)
            count_l.append(idx.size)
            leaf_runs.append(idx)
            pad_cursor += leaf_n
        else:
            first_l.append(0)
            count_l.append(0)
            left_idx, right_idx, _ = _split(idx)
            left_root = rec(left_idx)
            right_root = rec(right_idx)
            assert left_root == node_id + 1
            lo_l[node_id] = np.minimum(lo_l[left_root], lo_l[right_root])
            hi_l[node_id] = np.maximum(hi_l[left_root], hi_l[right_root])
        return node_id

    root = rec(np.arange(ntri, dtype=np.int64))
    assert root == 0
    sys.setrecursionlimit(old_limit)

    # Skip links, vectorized: in DFS pre-order the escape index of node i
    # is i + subtree_size(i) (same value the old per-subtree UNSET fill
    # produced); sizes by one reverse scan over the leaf flags.
    m = len(skip_l)
    count_arr = np.asarray(count_l, np.int32)
    size = np.ones(m, np.int64)
    for i in range(m - 1, -1, -1):
        if count_arr[i] == 0:  # inner: left child at i+1, right after it
            size[i] = 1 + size[i + 1] + size[i + 1 + size[i + 1]]
    skip = np.arange(m, dtype=np.int64) + size
    skip = np.where(skip >= m, -1, skip).astype(np.int32)

    # Pad each leaf run to leaf_n with a degenerate triangle (zero edges ->
    # det == 0 -> Möller–Trumbore rejects it). Vectorized scatter of all
    # runs at once (byte-identical to the old per-run copy loop).
    n_pad = pad_cursor
    pv0 = np.zeros((n_pad, 3), np.float32)
    pe1 = np.zeros((n_pad, 3), np.float32)
    pe2 = np.zeros((n_pad, 3), np.float32)
    pmat = np.zeros((n_pad,), np.int32)
    psrc = np.full((n_pad,), -1, np.int32)
    all_run = np.concatenate(leaf_runs) if leaf_runs else \
        np.empty(0, np.int64)
    lens = np.fromiter((r.size for r in leaf_runs), np.int64,
                       len(leaf_runs))
    offs = np.arange(all_run.size) - np.repeat(np.cumsum(lens) - lens,
                                               lens)
    dst = np.repeat(np.arange(len(leaf_runs), dtype=np.int64) * leaf_n,
                    lens) + offs
    pv0[dst] = v0[all_run]
    pe1[dst] = v1[all_run] - v0[all_run]
    pe2[dst] = v2[all_run] - v0[all_run]
    pmat[dst] = mat[all_run]
    psrc[dst] = all_run

    return BVH(
        lo=np.stack(lo_l).astype(np.float32),
        hi=np.stack(hi_l).astype(np.float32),
        skip=skip,
        first=np.asarray(first_l, np.int32),
        count=count_arr,
        tri_v0=pv0,
        tri_e1=pe1,
        tri_e2=pe2,
        tri_mat=pmat,
        tri_src=psrc,
    )


# --- triangle pre-splitting (SBVH-style spatial splits) --------------------
# The straggler packet's WALK (inner nodes whose box the ray union hits) is
# the one traversal quantity every round reschedule conserved. Spatial
# splits attack it at the source: a triangle whose AABB is large relative
# to its neighbours gets REFERENCE-DUPLICATED — several (tri_id, box)
# references with clipped, tighter boxes — before the SAH recursion, which
# then partitions references instead of triangles. Leaves store the
# ORIGINAL triangles (deduped per leaf), so the intersection math and the
# golden images are untouched: a duplicated triangle reached through
# either reference yields the identical t/normal/mat/gid, and the strict
# `t < t_best` winner test keeps the first instance.
#
# PRESPLIT_ALPHA is the reference budget as a fraction of the triangle
# count (0 = off, the production default). Flipped per-build via
# build_packet(presplit=...).
PRESPLIT_ALPHA = 0.0
# Split-candidate gate (box SA > PRESPLIT_THRESHOLD * median); see
# presplit_refs. 0.0 forces the budget spent on uniform meshes.
PRESPLIT_THRESHOLD = 2.0


def _clip_half_aabb(tv: np.ndarray, axis: int, m: np.ndarray, keep_hi: bool):
    """AABB of each triangle clipped to a half-space, vectorized.

    tv: (K,3,3) triangle vertices; m: (K,) plane offsets on `axis`.
    Returns (lo (K,3), hi (K,3), nonempty (K,)). The clipped polygon of a
    triangle against ONE plane has <= 4 vertices: the inside vertices
    plus the <= 2 crossing-edge intersection points — its AABB is the
    min/max over those candidates (no polygon bookkeeping needed).
    """
    x = tv[:, :, axis]                                   # (K,3)
    inside = x >= m[:, None] if keep_hi else x <= m[:, None]
    i0 = np.array([0, 1, 2])
    i1 = np.array([1, 2, 0])
    a = tv[:, i0]                                        # (K,3,3)
    b = tv[:, i1]
    xa, xb = x[:, i0], x[:, i1]
    cross = inside[:, i0] != inside[:, i1]               # (K,3)
    denom = np.where(xb - xa == 0, 1.0, xb - xa)
    tpar = np.clip((m[:, None] - xa) / denom, 0.0, 1.0)
    pts = a + tpar[..., None] * (b - a)                  # (K,3,3)
    cands = np.concatenate([tv, pts], axis=1)            # (K,6,3)
    valid = np.concatenate([inside, cross], axis=1)      # (K,6)
    lo = np.where(valid[..., None], cands, np.inf).min(axis=1)
    hi = np.where(valid[..., None], cands, -np.inf).max(axis=1)
    return lo, hi, valid.any(axis=1)


def presplit_refs(v0, v1, v2, alpha: float, threshold: float = 2.0):
    """Reference-duplication pre-pass: returns (rlo, rhi, rtri) with at
    most ``ntri * (1 + alpha)`` references. Each round splits the
    largest-surface-area references at the spatial midpoint of their
    longest axis, clipping the ORIGINAL triangle against the plane and
    intersecting with the parent reference box (monotonically tighter,
    always a superset of the contained geometry).

    threshold: only references with box SA > threshold * median are
    split candidates (2.0 = the production guard: uniform meshes skip
    the pass entirely). threshold=0 forces splitting UNIFORM refs too —
    the blob's max/median box SA is 1.66, so at the default threshold
    the pass is (correctly) a no-op there."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    tv = np.stack([v0, v1, v2], axis=1)                  # (T,3,3)
    rlo = tv.min(axis=1)
    rhi = tv.max(axis=1)
    ntri = v0.shape[0]
    rtri = np.arange(ntri, dtype=np.int64)
    budget = int(alpha * ntri)

    def sa(lo, hi):
        e = np.maximum(hi - lo, 0)
        return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

    while budget > 0:
        areas = sa(rlo, rhi)
        med = np.median(areas)
        # only references meaningfully larger than the population are
        # worth a split (uniform meshes mostly skip the pass entirely)
        big = np.nonzero(areas > threshold * med)[0]
        if big.size == 0:
            break
        order = big[np.argsort(-areas[big], kind="stable")]
        pick = order[: min(budget, order.size)]
        keep = np.ones(rtri.size, bool)
        keep[pick] = False

        plo, phi = rlo[pick], rhi[pick]
        ext = phi - plo
        axis_k = np.argmax(ext, axis=1)                  # (K,)
        m = (plo[np.arange(pick.size), axis_k]
             + phi[np.arange(pick.size), axis_k]) * 0.5
        ptv = tv[rtri[pick]]
        out_lo, out_hi, out_tri = [], [], []
        for ax in range(3):
            sel = axis_k == ax
            if not sel.any():
                continue
            for hi_side in (False, True):
                clo, chi, ok = _clip_half_aabb(ptv[sel], ax, m[sel],
                                               hi_side)
                clo = np.maximum(clo, plo[sel])
                chi = np.minimum(chi, phi[sel])
                if hi_side:
                    clo[:, ax] = np.maximum(clo[:, ax], m[sel])
                else:
                    chi[:, ax] = np.minimum(chi[:, ax], m[sel])
                ok &= np.all(clo <= chi, axis=1)
                out_lo.append(clo[ok])
                out_hi.append(chi[ok])
                out_tri.append(rtri[pick][sel][ok])
        new_lo = np.concatenate(out_lo)
        new_hi = np.concatenate(out_hi)
        new_tri = np.concatenate(out_tri)
        made = new_tri.size - pick.size
        if made <= 0:
            break
        rlo = np.concatenate([rlo[keep], new_lo])
        rhi = np.concatenate([rhi[keep], new_hi])
        rtri = np.concatenate([rtri[keep], new_tri])
        budget -= made
    return rlo.astype(np.float32), rhi.astype(np.float32), rtri


PACKET_LEAF_N = 32
# Triangles per packet leaf row. Chosen end to end on the previous
# accelerator (smaller leaves won isolated bounces but lost on the full
# megakernel: the deep-bounce tail is round-bound and pays their extra
# rounds without the volume saving); not yet measured on the H100.
LEAF_F = 12  # f32 slots per triangle in a packed leaf row

# bf16-packed node rows: box coords outward-rounded to bf16 and packed
# two-per-u32 slot, halving the per-adv-step column count. The slab
# ARITHMETIC stays f32 — bf16->f32 expansion is exact, and a box only
# ever gets LOOSER (lo rounds toward -inf, hi toward +inf), so the cull
# stays conservative and images stay byte-identical (winners can flip
# only on exact f32 t-ties via drain order, the octant-adoption
# boundary). Scene build packs the emitted f32 tables when this is set;
# kernels/traverse.py branches on the array dtype. Off: it lost end to
# end on the previous accelerator to its extra node visits.
PK_BF16_PACK = False


def _bf16_dir_bits(x: np.ndarray, toward_neg: bool) -> np.ndarray:
    """f32 -> bf16 bit pattern (in the u32 high half), directed rounding.

    Truncating the low 16 mantissa bits rounds toward ZERO; when bits
    were lost and the sign points the wrong way, stepping the bf16 ulp
    (+0x10000 on the magnitude bits — mantissa carry rolls into the
    exponent naturally) completes round-toward(-inf|+inf)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    t = b & np.uint32(0xFFFF0000)
    lost = (b & np.uint32(0xFFFF)) != 0
    neg = (b & np.uint32(0x80000000)) != 0
    bump = lost & (neg if toward_neg else ~neg)
    return np.where(bump, t + np.uint32(0x10000), t)


def pack_nodes_bf16(nodes: np.ndarray) -> np.ndarray:
    """(..., Mi, 16) f32 CIP rows -> same-shape u32 packed rows.

    Slots 0-5: (lo | hi<<16) bf16 pairs per (child, axis) — child L
    axes xyz then child R; lo rounded toward -inf, hi toward +inf.
    Slots 6-8: metaL/metaR/skip bit-unchanged. Slots 9-15 zero. Row
    width stays 16 so gathers are shape-identical to the f32 table and
    only the extracted column count changes."""
    flat = nodes.reshape(-1, nodes.shape[-1])
    out = np.zeros_like(flat, np.uint32)
    for child, off in ((0, 0), (1, 6)):
        for k in range(3):
            lo = _bf16_dir_bits(flat[:, off + k], toward_neg=True)
            hi = _bf16_dir_bits(flat[:, off + k + 3], toward_neg=False)
            out[:, child * 3 + k] = (lo >> np.uint32(16)) | hi
    out[:, 6:9] = np.ascontiguousarray(flat[:, 12:15]).view(np.uint32)
    return out.reshape(nodes.shape)


class PacketBVH(NamedTuple):
    """Child-in-parent (CIP) gather-minimal layout for packet traversal.

    Designed for a machine where an XLA gather costs a fixed few ns per
    *row* nearly independent of row width: the layout packs BOTH
    children's boxes
    into the parent's row — one gather per visit tests two subtrees, a
    missed child's subtree is never entered, and leaf children are
    enqueued for intersection without any node visit at all. Compared to
    a one-box-per-row skip-link layout (which visits every
    node whose parent hit), CIP visits only nodes whose OWN box hit,
    roughly halving both the gather count and the serial latency chain.

      nodes: (Mi, 16) f32 — one row per INNER node, DFS order:
        [loL.xyz, hiL.xyz, loR.xyz, hiR.xyz, metaL, metaR, skip, 0].
        meta child encoding: (inner_row << 1) | 0 or (leaf_row << 1) | 1.
        skip = the inner row that follows this subtree in DFS (-1 exits);
        a cursor that descends left reaches a hit right child through the
        skip chain, and a right child whose box missed costs at most one
        wasted visit (its children's boxes are contained, so they miss
        too).
      leaves: (L, LEAF_F * PACKET_LEAF_N) f32 — per leaf row, PACKET_LEAF_N
        triangles COMPONENT-MAJOR: [all v0x, all v0y, ..., all mat_bits,
        all gid_bits, pad], padded with degenerate triangles. One row
        gather yields the whole leaf; component-major means the leaf
        phase (kernels/traverse.leaf_hits) slices 2D (P, LN) component
        blocks with no reshape, as contiguous slices.
      cut: (8, 2) int32 — 8 disjoint [start, end) row spans covering all
        inner rows, balanced by row count, for the multi-cursor tail
        (kernels/traverse.py): K independent gather chains overlap,
        dividing the latency-bound round count by ~K.

    Re-sorting rays by direction each bounce (trace.ray_coherence_key)
    lost on the previous accelerator: pixel-tile order already groups
    rays by origin, and a direction sort trades that for direction
    grouping, WIDENING the per-packet node-set union. Resort stays off.
    """

    nodes: np.ndarray    # (Mi, 16) f32
    leaves: np.ndarray   # (L, PACKET_LEAF_N*10) f32
    n_nodes: int
    cut: np.ndarray      # (8, 2) int32
    # Optional octant-ordered tables (build_packet(octants=True)):
    # oct_nodes[o] is the SAME topology re-flattened so that, for a ray
    # whose direction-sign octant is o (bit a set = d[a] < 0), the NEAR
    # child by the node's SAH split axis always sits in the L slots —
    # left-first descent then IS front-to-back, tightening t_best
    # earlier and letting the slab test cull far subtrees. Leaf rows are
    # shared (leaf ids identical across octants); only inner-row order,
    # metas, skips and cuts differ. oct_nodes[0] == nodes bit-exactly.
    oct_nodes: Optional[np.ndarray] = None   # (8, Mi, 16) f32
    oct_cut: Optional[np.ndarray] = None     # (8, 8, 2) int32


def _uniq_keep_order(a: np.ndarray) -> np.ndarray:
    """First occurrence of each value, original order (leaf dedup for
    spatial-split reference runs; identity when a has no duplicates)."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def build_packet(v0, v1, v2, mat, leaf_n: int = PACKET_LEAF_N,
                 presplit: float = None,
                 octants: bool = False) -> PacketBVH:
    """Build the CIP packet layout (binned-SAH topology).

    octants=True additionally emits the 8 direction-octant re-flattens
    (PacketBVH.oct_nodes/oct_cut docstring); the base table is always
    octant 0, so nothing upstream changes.

    presplit > 0 runs the spatial-split reference pre-pass (SBVH-style,
    see presplit_refs): the SAH recursion then partitions clipped-box
    REFERENCES and leaves store the deduped original triangles. With
    presplit = 0 (the default via PRESPLIT_ALPHA) every step below is
    bit-identical to the builder without the pre-pass."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    mat = np.asarray(mat, np.int32)
    ntri = v0.shape[0]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)

    alpha = PRESPLIT_ALPHA if presplit is None else presplit
    if alpha > 0:
        rlo, rhi, rtri = presplit_refs(v0, v1, v2, alpha,
                                       threshold=PRESPLIT_THRESHOLD)
        dedup = _uniq_keep_order
    else:
        rlo, rhi = tlo, thi
        rtri = np.arange(ntri, dtype=np.int64)
        dedup = None  # identity refs: runs can have no duplicates
    centroid = (rlo + rhi) * 0.5

    # --- topology (one recursive build) -----------------------------------
    n_lo: list = []
    n_hi: list = []
    n_kids: list = []
    leaf_runs: list = []
    n_leaf: list = []   # leaf row id or -1
    n_axis: list = []   # SAH split axis (inner nodes; 0 for leaves)

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    _split = _partitioner(rlo, rhi, centroid)

    def rec(idx: np.ndarray) -> int:
        # inner-node bounds from child unions — bit-identical to
        # reducing over idx (min/max are exact under any grouping)
        nid = len(n_lo)
        n_lo.append(None)
        n_hi.append(None)
        n_kids.append((-1, -1))
        n_leaf.append(-1)
        n_axis.append(0)
        if idx.size <= leaf_n:
            n_lo[nid] = rlo[idx].min(axis=0)
            n_hi[nid] = rhi[idx].max(axis=0)
            n_leaf[nid] = len(leaf_runs)
            run = rtri[idx] if dedup is None else dedup(rtri[idx])
            leaf_runs.append(run)
        else:
            left_idx, right_idx, axis = _split(idx)
            n_axis[nid] = axis
            left = rec(left_idx)
            right = rec(right_idx)
            n_kids[nid] = (left, right)
            n_lo[nid] = np.minimum(n_lo[left], n_lo[right])
            n_hi[nid] = np.maximum(n_hi[left], n_hi[right])
        return nid

    root = rec(np.arange(rtri.size, dtype=np.int64))

    # --- CIP inner-row emission (DFS) --------------------------------------
    # A single-leaf tree has no inner rows; emit a degenerate root row
    # whose left child is the leaf and whose right child is an empty box.
    # Parameterized by the direction-sign octant: at an inner node split
    # on axis a, the L slots hold the LOW-coordinate child unless bit a
    # of swap_bits is set (ray direction negative along a => the high
    # side is nearer), so left-first descent is front-to-back for that
    # octant. swap_bits=0 is the unswapped table (the plain DFS emission).
    def _emit_table(swap_bits: int):
        row_lo_l: list = []
        row_hi_l: list = []
        row_lo_r: list = []
        row_hi_r: list = []
        row_meta: list = []     # (metaL, metaR) filled post-emit

        def emit(nid: int) -> int:
            row = len(row_meta)
            row_meta.append(None)
            l, r = n_kids[nid]
            if (swap_bits >> n_axis[nid]) & 1:
                l, r = r, l
            row_lo_l.append(n_lo[l]); row_hi_l.append(n_hi[l])
            row_lo_r.append(n_lo[r]); row_hi_r.append(n_hi[r])
            mL = (n_leaf[l] << 1) | 1 if n_leaf[l] >= 0 else (emit(l) << 1)
            mR = (n_leaf[r] << 1) | 1 if n_leaf[r] >= 0 else (emit(r) << 1)
            row_meta[row] = (mL, mR)
            return row

        if n_kids[root][0] >= 0:
            emit(root)
            mi = len(row_meta)
        else:
            inf = np.full(3, np.inf, np.float32)
            row_lo_l.append(n_lo[root]); row_hi_l.append(n_hi[root])
            row_lo_r.append(inf); row_hi_r.append(-inf)
            row_meta.append(((n_leaf[root] << 1) | 1, (0 << 1) | 1))
            # right child: empty box never hits, so its (bogus) leaf id
            # is never enqueued
            mi = 1

        # subtree row spans: DFS property — a row's subtree occupies
        # [row, row + inner_size); sizes in reverse emission order
        size = np.ones(mi, np.int64)
        for row in range(mi - 1, -1, -1):
            mL, mR = row_meta[row]
            if not (mL & 1):
                size[row] += size[mL >> 1]
            if not (mR & 1):
                size[row] += size[mR >> 1]
        skip = np.arange(mi, dtype=np.int64) + size
        skip = np.where(skip >= mi, -1, skip).astype(np.int32)

        nodes = np.zeros((mi, 16), np.float32)
        nodes[:, 0:3] = np.stack(row_lo_l)
        nodes[:, 3:6] = np.stack(row_hi_l)
        nodes[:, 6:9] = np.stack(row_lo_r)
        nodes[:, 9:12] = np.stack(row_hi_r)
        nodes[:, 12] = np.asarray([m[0] for m in row_meta],
                                  np.int32).view(np.float32)
        nodes[:, 13] = np.asarray([m[1] for m in row_meta],
                                  np.int32).view(np.float32)
        nodes[:, 14] = skip.view(np.float32)

        # K-way row-span cut (multi-cursor tail): split the largest span
        # at its top row — [s, mid) keeps the top row (whose leaf-child
        # enqueues must still happen) + the left subtree; [mid, e) is
        # the right child's subtree when inner, else just the left
        # subtree split off the top row.
        pieces = [(0, mi)]
        while len(pieces) < 8:
            pieces.sort(key=lambda se: se[0] - se[1])   # largest first
            for i, (s, e) in enumerate(pieces):
                if e - s < 2:
                    continue
                mL, mR = row_meta[s]
                if not (mR & 1) and s < (mR >> 1) < e:
                    mid = mR >> 1
                else:
                    mid = s + 1
                pieces.pop(i)
                pieces.extend([(s, mid), (mid, e)])
                break
            else:
                break
        cut = np.full((8, 2), -1, np.int32)
        for i, (s, e) in enumerate(sorted(pieces)):
            cut[i] = (s, e)
        return nodes, cut

    nodes, cut = _emit_table(0)
    oct_nodes = oct_cut = None
    if octants:
        tabs = [(nodes, cut)] + [_emit_table(o) for o in range(1, 8)]
        oct_nodes = np.stack([t[0] for t in tabs])      # (8, mi, 16)
        oct_cut = np.stack([t[1] for t in tabs])        # (8, 8, 2)
    sys.setrecursionlimit(old)
    mi = nodes.shape[0]

    # --- packed leaf rows ---------------------------------------------------
    # component-major, 12 f32 slots per triangle: slot k holds component k
    # of ALL leaf_n triangles — [v0.xyz, e1.xyz, e2.xyz, mat_bits,
    # gid_bits, 0]; gid is the ORIGINAL triangle index (-1 on padding
    # slots) and feeds the optional vn shading-normal lookup (A.5).
    n_rows = len(leaf_runs)
    leaves = np.zeros((n_rows, LEAF_F, leaf_n), np.float32)
    leaves[:, 10, :] = np.full((n_rows, leaf_n), -1, np.int32).view(np.float32)
    # vectorized scatter of all runs at once (byte-identical to the
    # old per-run copy loop)
    _runs = leaf_runs
    if _runs:
        all_run = np.concatenate(_runs)
        lens = np.fromiter((r.size for r in _runs), np.int64, len(_runs))
        rows_r = np.repeat(np.arange(len(_runs), dtype=np.int64), lens)
        offs = np.arange(all_run.size) - np.repeat(
            np.cumsum(lens) - lens, lens)
        ga_v0 = v0[all_run]
        ga_e1 = v1[all_run] - ga_v0
        ga_e2 = v2[all_run] - ga_v0
        for k in range(3):
            leaves[rows_r, k, offs] = ga_v0[:, k]
            leaves[rows_r, 3 + k, offs] = ga_e1[:, k]
            leaves[rows_r, 6 + k, offs] = ga_e2[:, k]
        leaves[rows_r, 9, offs] = mat[all_run].view(np.float32)
        leaves[rows_r, 10, offs] = all_run.astype(np.int32).view(
            np.float32)

    return PacketBVH(nodes=nodes,
                     leaves=leaves.reshape(n_rows, LEAF_F * leaf_n),
                     n_nodes=mi, cut=cut,
                     oct_nodes=oct_nodes, oct_cut=oct_cut)


WIDE_FANOUT = 8
WIDE_F = 64  # f32 slots per wide node row


class PacketBVH8(NamedTuple):
    """Wide-fanout (8-ary) child-in-parent layout.

    The binary CIP layout (PacketBVH) tests TWO subtrees per row gather;
    where a gather costs the same whatever the row width, a 64-f32 row
    testing EIGHT subtrees costs the same gather — cutting tree depth,
    and with it the serial gather->slab->select chain, by ~3x vs binary.
    Off by default (kernels/traverse.WIDE_ENABLE).

      nodes: (Mw, 64) f32 — one row per wide node, DFS order,
        COMPONENT-MAJOR boxes so the slab math slices contiguous blocks:
          slots  0..7   lo_x of child 0..7      24..31  hi_x
          slots  8..15  lo_y                    32..39  hi_y
          slots 16..23  lo_z                    40..47  hi_z
          slots 48..55  meta[8] (int32 bits):
                          inner child -> (wide_row << 1) | 0
                          leaf child  -> (leaf_rank << 1) | 1
                          empty slot  -> -1 (traversal masks on meta < 0;
                          an "inverted box never hits" encoding is WRONG —
                          the slab test's per-axis min/max un-inverts it
                          into a hit-everything box, a latent waste bug in
                          the binary layout's single-leaf degenerate row
                          that is only harmless there because leaf id 0 is
                          idempotent. Empty boxes here are zeros, which
                          also keeps debug_nans renders clean.)
          slot  56      skip (int32 bits; next DFS row after this subtree,
                        -1 exits)
          slot  57      leaf_base (int32 bits; the row in `leaves` of this
                        node's FIRST leaf child — leaf children are laid
                        out contiguously, child-order, so leaf child with
                        rank r lives at leaves[leaf_base + r])
          slots 58..63  pad (zeros)
      leaves: (L, LEAF_F * PACKET_LEAF_N) f32 — identical per-row format
        to PacketBVH.leaves, but re-ordered so each wide node's leaf
        children are contiguous. This lets a traversal visit enqueue ALL
        its hit leaf children as ONE ring entry (leaf_base << 8 | hitmask)
        instead of up to 8 pushes; the drain phase pops one set bit per
        drain (kernels/traverse.py).
      cut: (8, 2) int32 — disjoint row spans for the multi-cursor tail,
        same contract as PacketBVH.cut.

    Topology: the same binned-SAH binary tree as build_packet, greedily
    collapsed — each wide node's children start as the binary node's two
    children and the largest-triangle-count inner child is repeatedly
    replaced by its two children (order-preserving) until 8 slots are
    filled or every child is a leaf.
    """

    nodes: np.ndarray    # (Mw, 64) f32
    leaves: np.ndarray   # (L, PACKET_LEAF_N*LEAF_F) f32
    n_nodes: int
    cut: np.ndarray      # (8, 2) int32


def build_packet8(v0, v1, v2, mat,
                  leaf_n: int = PACKET_LEAF_N,
                  fanout: int = WIDE_FANOUT) -> PacketBVH8:
    """Build the wide-fanout CIP layout (binned-SAH topology collapsed).

    fanout: children per wide node (8; or 4: each visit tests the four
    boxes TWO binary levels down — the same box-test volume as two
    binary steps with HALF the serial gather->reduce->select links).
    Row width is 8*fanout f32 slots:
    boxes component-major in 6*fanout, metas at 6F..7F, skip at 7F,
    leaf_base at 7F+1, rest pad. The traversal infers fanout from the
    row width (kernels/traverse.py)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    mat = np.asarray(mat, np.int32)
    ntri = v0.shape[0]
    tlo = np.minimum(np.minimum(v0, v1), v2)
    thi = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tlo + thi) * 0.5

    # --- binary topology (same recursion as build_packet) ------------------
    n_lo: list = []
    n_hi: list = []
    n_kids: list = []
    n_leaf: list = []     # leaf-run id or -1
    n_count: list = []    # subtree triangle count (expansion priority)
    leaf_runs: list = []

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    _split = _partitioner(tlo, thi, centroid)

    def rec(idx: np.ndarray) -> int:
        # child-union bounds (bit-identical: min/max regroup exactly)
        nid = len(n_lo)
        n_lo.append(None)
        n_hi.append(None)
        n_kids.append((-1, -1))
        n_leaf.append(-1)
        n_count.append(idx.size)
        if idx.size <= leaf_n:
            n_lo[nid] = tlo[idx].min(axis=0)
            n_hi[nid] = thi[idx].max(axis=0)
            n_leaf[nid] = len(leaf_runs)
            leaf_runs.append(idx)
        else:
            left_idx, right_idx, _ = _split(idx)
            left = rec(left_idx)
            right = rec(right_idx)
            n_kids[nid] = (left, right)
            n_lo[nid] = np.minimum(n_lo[left], n_lo[right])
            n_hi[nid] = np.maximum(n_hi[left], n_hi[right])
        return nid

    root = rec(np.arange(ntri, dtype=np.int64))

    # --- greedy 3-level collapse + wide DFS emission -----------------------
    def children_of(nid: int) -> list[int]:
        kids = list(n_kids[nid])
        while len(kids) < fanout:
            inner = [(n_count[k], i) for i, k in enumerate(kids)
                     if n_leaf[k] < 0]
            if not inner:
                break
            _, i = max(inner)
            kids[i:i + 1] = list(n_kids[kids[i]])
        return kids

    row_boxes: list = []     # (lo (8,3), hi (8,3))
    row_meta: list = []      # list of 8 ints
    row_base: list = []      # leaf_base
    leaf_order: list = []    # run ids in new leaf-row order

    def emit(nid: int) -> int:
        kids = children_of(nid)
        row = len(row_meta)
        row_meta.append(None)
        row_boxes.append(None)
        row_base.append(0)
        lo = np.zeros((fanout, 3), np.float32)
        hi = np.zeros((fanout, 3), np.float32)
        meta = [-1] * fanout
        base = len(leaf_order)
        rank = 0
        for i, k in enumerate(kids):
            lo[i], hi[i] = n_lo[k], n_hi[k]
            if n_leaf[k] >= 0:
                meta[i] = (rank << 1) | 1
                leaf_order.append(n_leaf[k])
                rank += 1
        # inner children emitted AFTER this row's leaf-run assignment so
        # each wide node's leaf children stay contiguous
        for i, k in enumerate(kids):
            if n_leaf[k] < 0:
                meta[i] = emit(k) << 1
        row_boxes[row] = (lo, hi)
        row_meta[row] = meta
        row_base[row] = base
        return row

    if n_kids[root][0] >= 0:
        emit(root)
        mw = len(row_meta)
    else:
        # single-leaf tree: one degenerate row, child 0 = the leaf
        lo = np.zeros((fanout, 3), np.float32)
        hi = np.zeros((fanout, 3), np.float32)
        lo[0], hi[0] = n_lo[root], n_hi[root]
        row_boxes.append((lo, hi))
        row_meta.append([1] + [-1] * (fanout - 1))
        row_base.append(0)
        leaf_order.append(n_leaf[root])
        mw = 1
    sys.setrecursionlimit(old)

    # subtree sizes -> skip links (DFS property, reverse order)
    size = np.ones(mw, np.int64)
    for row in range(mw - 1, -1, -1):
        for m in row_meta[row]:
            if not (m & 1):
                size[row] += size[m >> 1]
    skip = np.arange(mw, dtype=np.int64) + size
    skip = np.where(skip >= mw, -1, skip).astype(np.int32)

    F = fanout
    nodes = np.zeros((mw, 8 * F), np.float32)
    for row in range(mw):
        lo, hi = row_boxes[row]
        for c in range(3):
            nodes[row, c * F:(c + 1) * F] = lo[:, c]
            nodes[row, 3 * F + c * F:3 * F + (c + 1) * F] = hi[:, c]
    nodes[:, 6 * F:7 * F] = np.asarray(row_meta, np.int32).view(np.float32)
    nodes[:, 7 * F] = skip.view(np.float32)
    nodes[:, 7 * F + 1] = np.asarray(row_base, np.int32).view(np.float32)

    # --- packed leaf rows in wide order ------------------------------------
    n_rows = len(leaf_order)
    leaves = np.zeros((n_rows, LEAF_F, leaf_n), np.float32)
    leaves[:, 10, :] = np.full((n_rows, leaf_n), -1,
                               np.int32).view(np.float32)
    # vectorized scatter of all runs at once (byte-identical to the
    # old per-run copy loop)
    _runs = [leaf_runs[r] for r in leaf_order]
    if _runs:
        all_run = np.concatenate(_runs)
        lens = np.fromiter((r.size for r in _runs), np.int64, len(_runs))
        rows_r = np.repeat(np.arange(len(_runs), dtype=np.int64), lens)
        offs = np.arange(all_run.size) - np.repeat(
            np.cumsum(lens) - lens, lens)
        ga_v0 = v0[all_run]
        ga_e1 = v1[all_run] - ga_v0
        ga_e2 = v2[all_run] - ga_v0
        for k in range(3):
            leaves[rows_r, k, offs] = ga_v0[:, k]
            leaves[rows_r, 3 + k, offs] = ga_e1[:, k]
            leaves[rows_r, 6 + k, offs] = ga_e2[:, k]
        leaves[rows_r, 9, offs] = mat[all_run].view(np.float32)
        leaves[rows_r, 10, offs] = all_run.astype(np.int32).view(
            np.float32)

    # --- K-way row-span cut (multi-cursor tail; same contract as binary:
    # every span starts at a subtree root or at a row whose preceding
    # split kept the parent in the other span, so skip chains cover it) --
    pieces = [(0, mw)]
    while len(pieces) < 8:
        pieces.sort(key=lambda se: se[0] - se[1])   # largest first
        for i, (s, e) in enumerate(pieces):
            if e - s < 2:
                continue
            # split at the inner-child row of s nearest the span middle
            kid_rows = [m >> 1 for m in row_meta[s]
                        if not (m & 1) and s < (m >> 1) < e]
            if kid_rows:
                mid = min(kid_rows, key=lambda r: abs(r - (s + e) // 2))
            else:
                mid = s + 1
            pieces.pop(i)
            pieces.extend([(s, mid), (mid, e)])
            break
        else:
            break
    cut = np.full((8, 2), -1, np.int32)
    for i, (s, e) in enumerate(sorted(pieces)):
        cut[i] = (s, e)

    return PacketBVH8(nodes=nodes,
                      leaves=leaves.reshape(n_rows, LEAF_F * leaf_n),
                      n_nodes=mw, cut=cut)


def validate(b: BVH) -> None:
    """Structural invariants, used by tests (SURVEY.md §4 'BVH' row)."""
    m = b.lo.shape[0]
    assert b.skip.shape == (m,) and b.count.shape == (m,)
    assert np.all(b.lo <= b.hi + 1e-6)
    ids = np.arange(m)
    ok = (b.skip == -1) | (b.skip > ids)
    assert np.all(ok), "skip links must move forward in DFS order"
    leaves = b.count > 0
    assert np.all(b.first[leaves] % LEAF_N == 0)
    assert np.all(b.first[leaves] + b.count[leaves] <= b.tri_v0.shape[0])
    # Leaf bboxes contain their (real) triangles.
    for nid in np.nonzero(leaves)[0][:256]:
        f, c = int(b.first[nid]), int(b.count[nid])
        vs = np.concatenate(
            [
                b.tri_v0[f : f + c],
                b.tri_v0[f : f + c] + b.tri_e1[f : f + c],
                b.tri_v0[f : f + c] + b.tri_e2[f : f + c],
            ]
        )
        assert np.all(vs >= b.lo[nid] - 1e-4) and np.all(vs <= b.hi[nid] + 1e-4)
