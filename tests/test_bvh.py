"""BVH build invariants + traversal == brute force (SURVEY.md §4 Unit BVH)."""

import jax.numpy as jnp
import numpy as np

from tpurt import bvh, geometry, scene as scene_mod, trace


def _soup(mesh):
    v, f = mesh
    v = np.asarray(v, np.float32)
    return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], np.zeros(len(f), np.int32)


def test_build_invariants(micro_mesh):
    tree = bvh.build(*_soup(micro_mesh))
    bvh.validate(tree)
    # root bbox contains every vertex
    v = np.asarray(micro_mesh[0], np.float32)
    assert np.all(v >= tree.lo[0] - 1e-4) and np.all(v <= tree.hi[0] + 1e-4)
    # leaf counts sum to the triangle count
    assert tree.count.sum() == len(micro_mesh[1])


def test_traversal_matches_brute(micro_mesh, rays_random):
    v, f = micro_mesh
    sc_bvh, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
    o, d = (jnp.asarray(x) for x in rays_random)

    t_max = jnp.full(o.shape[0], geometry.INF)
    t_bvh, tri = trace.bvh_nearest_tri(sc_bvh.device(), o, d, t_max)

    t_brute, _, _, hit_brute, _ = geometry.hit_triangles_brute(
        o, d, jnp.asarray(sc_bvh.tri_v0), jnp.asarray(sc_bvh.tri_e1),
        jnp.asarray(sc_bvh.tri_e2), jnp.asarray(sc_bvh.tri_mat), t_max
    )
    hit_bvh = np.asarray(tri) >= 0
    assert np.array_equal(hit_bvh, np.asarray(hit_brute))
    assert np.allclose(np.asarray(t_bvh)[hit_bvh],
                       np.asarray(t_brute)[hit_bvh], rtol=1e-5)


def test_single_triangle_tree():
    tree = bvh.build(
        np.array([[0, 0, 0]], np.float32),
        np.array([[1, 0, 0]], np.float32),
        np.array([[0, 1, 0]], np.float32),
        np.array([5], np.int32),
    )
    bvh.validate(tree)
    assert tree.lo.shape[0] == 1 and tree.count[0] == 1
    assert tree.skip[0] == -1


def _rand_rays(n, seed=3):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    target = rs.uniform(-0.8, 0.8, size=(n, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_wide_build_invariants(micro_mesh):
    """PacketBVH8 structural invariants (round-3 wide-fanout layout)."""
    pk8 = bvh.build_packet8(*_soup(micro_mesh))
    mw = pk8.n_nodes
    assert pk8.nodes.shape == (mw, bvh.WIDE_F)
    metas = pk8.nodes[:, 48:56].view(np.int32)
    skip = pk8.nodes[:, 56].view(np.int32)
    base = pk8.nodes[:, 57].view(np.int32)
    n_leaf_rows = pk8.leaves.shape[0]
    ranks_seen = 0
    for row in range(mw):
        n_leaf_kids = 0
        for m in metas[row]:
            if m < 0:
                continue  # empty slot
            if m & 1:
                rank = m >> 1
                assert rank == n_leaf_kids  # contiguous child-order ranks
                assert base[row] + rank < n_leaf_rows
                n_leaf_kids += 1
            else:
                child = m >> 1
                assert row < child < mw  # DFS forward
        ranks_seen += n_leaf_kids
        s = skip[row]
        assert s == -1 or row < s <= mw
    assert ranks_seen == n_leaf_rows  # every leaf row owned exactly once
    # every triangle appears exactly once across leaf rows (gid slots)
    gids = pk8.leaves.reshape(n_leaf_rows, bvh.LEAF_F,
                              bvh.PACKET_LEAF_N)[:, 10].view(np.int32)
    real = gids[gids >= 0]
    assert sorted(real.tolist()) == list(range(len(micro_mesh[1])))


def test_wide_traversal_matches_binary(micro_mesh):
    """Wide (8-ary) and binary packet traversal agree exactly: same found
    mask, same t, same winner gid/mat (the layouts intersect identical
    triangle rows; only the visit schedule differs)."""
    from tpurt.kernels import traverse

    v, f = micro_mesh
    # pk8 is built lazily, only when WIDE_ENABLE is set at BUILD time
    old = traverse.WIDE_ENABLE
    try:
        traverse.WIDE_ENABLE = True
        sc, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
        sc = sc.device()
        assert sc.pk8_nodes is not None
        o, d = _rand_rays(1024)
        t_max = jnp.full(o.shape[0], geometry.INF)
        wide = traverse.packet_nearest_tri(sc, o, d, t_max)
    finally:
        traverse.WIDE_ENABLE = old
    sc_bin = sc._replace(pk8_nodes=None, pk8_leaves=None, pk8_cut=None)
    binry = traverse.packet_nearest_tri(sc_bin, o, d, t_max)

    t8, n8, m8, f8, g8 = (np.asarray(x) for x in wide)
    t2, n2, m2, f2, g2 = (np.asarray(x) for x in binry)
    assert np.array_equal(f8, f2)
    assert np.array_equal(t8[f2], t2[f2])
    assert np.array_equal(g8[f2], g2[f2])
    assert np.array_equal(m8[f2], m2[f2])
    assert np.array_equal(n8[f2], n2[f2])


def test_wide4_traversal_matches_binary(micro_mesh):
    """Fanout-4 wide layout (build_packet8(fanout=4), round-4): exact
    agreement with the binary packet traversal, same contract as the
    fanout-8 test."""
    from tpurt.kernels import traverse

    v, f = micro_mesh
    sc, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
    v0, v1, v2, _ = _soup(micro_mesh)
    # mesh_scene assigns the mesh its body material (id 1) — the pk4
    # leaf rows must carry the same ids for the mat winner comparison
    pk4 = bvh.build_packet8(v0, v1, v2,
                            np.ones(v0.shape[0], np.int32), fanout=4)
    assert pk4.nodes.shape[1] == 32
    sc4 = sc._replace(pk8_nodes=pk4.nodes, pk8_leaves=pk4.leaves,
                      pk8_cut=pk4.cut).device()
    o, d = _rand_rays(1024)
    t_max = jnp.full(o.shape[0], geometry.INF)

    old = traverse.WIDE_ENABLE
    try:
        traverse.WIDE_ENABLE = True
        wide = traverse.packet_nearest_tri(sc4, o, d, t_max)
    finally:
        traverse.WIDE_ENABLE = old
    sc_bin = sc4._replace(pk8_nodes=None, pk8_leaves=None, pk8_cut=None)
    binry = traverse.packet_nearest_tri(sc_bin, o, d, t_max)

    t4, n4, m4, f4, g4 = (np.asarray(x) for x in wide)
    t2, n2, m2, f2, g2 = (np.asarray(x) for x in binry)
    assert np.array_equal(f4, f2)
    assert np.array_equal(t4[f2], t2[f2])
    assert np.array_equal(g4[f2], g2[f2])
    assert np.array_equal(m4[f2], m2[f2])
    assert np.array_equal(n4[f2], n2[f2])


def test_presplit_traversal_matches_plain(micro_mesh):
    """Spatial-split references (bvh.presplit_refs) change only the tree
    SHAPE: packet traversal over a presplit build must return the exact
    same winners (found/t/gid/mat/normal) as the plain build — duplicated
    references resolve to the identical triangle row, and the strict
    t < t_best keeps the first instance."""
    from tpurt.kernels import traverse

    v, f = micro_mesh
    v = np.asarray(v, np.float64).copy()
    # stretch a few triangles into large slivers so the pass actually
    # splits something (uniform meshes mostly skip it)
    v[0] += np.array([4.0, 0.02, 0.01])
    v[5] += np.array([0.01, 4.0, 0.02])
    sc_plain, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)

    # threshold=0 forces the budget to be spent even where no ref clears
    # the 2x-median area gate (the forced mode) — winner
    # exactness must hold for splits of uniform refs too
    old = (bvh.PRESPLIT_ALPHA, bvh.PRESPLIT_THRESHOLD)
    bvh.PRESPLIT_ALPHA = 1.0
    bvh.PRESPLIT_THRESHOLD = 0.0
    try:
        sc_split, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
    finally:
        bvh.PRESPLIT_ALPHA, bvh.PRESPLIT_THRESHOLD = old
    # the pass must have actually duplicated references
    assert sc_split.pk_leaves.shape[0] >= sc_plain.pk_leaves.shape[0]

    rs = np.random.RandomState(7)
    o = jnp.asarray(rs.uniform(-3, 3, (1024, 3)).astype(np.float32))
    dirs = rs.normal(size=(1024, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = jnp.asarray(dirs)
    t_max = jnp.full(1024, geometry.INF)

    a = traverse.packet_nearest_tri(sc_plain.device(), o, d, t_max)
    b = traverse.packet_nearest_tri(sc_split.device(), o, d, t_max)
    ta, na, ma, fa, ga = (np.asarray(x) for x in a)
    tb, nb, mb, fb, gb = (np.asarray(x) for x in b)
    assert np.array_equal(fa, fb)
    assert np.array_equal(ta[fa], tb[fa])
    assert np.array_equal(ga[fa], gb[fa])
    assert np.array_equal(ma[fa], mb[fa])
    assert np.array_equal(na[fa], nb[fa])


def test_wide_single_leaf_tree():
    """Degenerate wide tree over <= PACKET_LEAF_N triangles: one row whose
    child 0 is the only leaf, empty slots meta -1."""
    v0 = np.array([[0, 0, 0], [2, 0, 0]], np.float32)
    v1 = np.array([[1, 0, 0], [3, 0, 0]], np.float32)
    v2 = np.array([[0, 1, 0], [2, 1, 0]], np.float32)
    pk8 = bvh.build_packet8(v0, v1, v2, np.zeros(2, np.int32))
    assert pk8.n_nodes == 1 and pk8.leaves.shape[0] == 1
    metas = pk8.nodes[:, 48:56].view(np.int32)
    assert metas[0, 0] == 1 and np.all(metas[0, 1:] == -1)

def test_octant_tables_invariants(micro_mesh):
    """build_packet(octants=True): octant 0 IS the base table bit-exactly;
    every octant re-flatten is the same topology (same row count, same
    multiset of child boxes and leaf references, valid skip spans)."""
    pk = bvh.build_packet(*_soup(micro_mesh), octants=True)
    assert pk.oct_nodes is not None and pk.oct_nodes.shape == (
        8, pk.n_nodes, 16)
    assert pk.oct_cut is not None and pk.oct_cut.shape == (8, 8, 2)
    # bitwise compare: the int-payload columns (metas, skip) hold bit
    # patterns that are NaN as f32 (skip -1 = 0xffffffff)
    assert np.array_equal(pk.oct_nodes[0].view(np.uint32),
                          pk.nodes.view(np.uint32))
    assert np.array_equal(pk.oct_cut[0], pk.cut)
    mi = pk.n_nodes

    def leaf_multiset(tab):
        metas = tab[:, 12:14].view(np.int32)
        return sorted((m >> 1) for m in metas.reshape(-1) if m & 1)

    base_leaves = leaf_multiset(pk.nodes)
    base_boxes = np.sort(
        np.concatenate([pk.nodes[:, 0:6], pk.nodes[:, 6:12]]), axis=0)
    for o in range(1, 8):
        tab = pk.oct_nodes[o]
        assert leaf_multiset(tab) == base_leaves
        boxes = np.sort(
            np.concatenate([tab[:, 0:6], tab[:, 6:12]]), axis=0)
        assert np.array_equal(boxes, base_boxes)
        skip = tab[:, 14].view(np.int32)
        assert np.all((skip == -1) | ((skip > np.arange(mi)) & (skip < mi)))


def test_octant_traversal_matches_base(micro_mesh):
    """OCT_ENABLE traversal returns the exact same winners as the base
    left-first order — child visit order only changes WHEN t_best
    tightens, never the strict-< winner. Covers both the multi-cursor
    narrow path (1024 rays = 8 packets <= MC_PACKETS) and the full-width
    staged path (16384 rays = 128 packets > MC_PACKETS)."""
    from tpurt.kernels import traverse

    v, f = micro_mesh
    old = traverse.OCT_ENABLE
    try:
        traverse.OCT_ENABLE = True
        sc, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
        sc = sc.device()
        assert sc.pk_oct_nodes is not None
        for n in (1024, 16384):
            o, d = _rand_rays(n)
            t_max = jnp.full(n, geometry.INF)
            traverse.OCT_ENABLE = True
            a = traverse.packet_nearest_tri(sc, o, d, t_max)
            traverse.OCT_ENABLE = False
            b = traverse.packet_nearest_tri(sc, o, d, t_max)
            ta, na, ma, fa, ga = (np.asarray(x) for x in a)
            tb, nb, mb, fb, gb = (np.asarray(x) for x in b)
            assert np.array_equal(fa, fb)
            assert np.array_equal(ta[fb], tb[fb])
            assert np.array_equal(ga[fb], gb[fb])
            assert np.array_equal(ma[fb], mb[fb])
            assert np.array_equal(na[fb], nb[fb])
    finally:
        traverse.OCT_ENABLE = old


def test_bf16_pack_directed_rounding():
    """pack_nodes_bf16: every lo rounds toward -inf and every hi toward
    +inf (boxes only get LOOSER — the conservative-cull contract), the
    expansion is exact f32, values already bf16-representable are
    unchanged, and the meta slots carry their bits through untouched."""
    rng = np.random.default_rng(7)
    rows = np.zeros((4096, 16), np.float32)
    vals = np.float32(rng.normal(scale=10.0, size=(4096, 12)))
    vals[0, :] = 0.0
    vals[1, :] = -0.0
    vals[2, :] = 1.5          # bf16-exact
    vals[3, :] = 2.0**120     # bf16-exact (power of two, huge exponent)
    rows[:, :12] = vals
    meta = rng.integers(-(2**31), 2**31, size=(4096, 3), dtype=np.int64)
    rows[:, 12:15] = meta.astype(np.int32).view(np.float32)

    packed = bvh.pack_nodes_bf16(rows)
    assert packed.dtype == np.uint32 and packed.shape == rows.shape
    lo_u = (packed[:, 0:6] << np.uint32(16)).view(np.float32)
    hi_u = (packed[:, 0:6] & np.uint32(0xFFFF0000)).view(np.float32)
    lo_f = np.concatenate([rows[:, 0:3], rows[:, 6:9]], axis=1)
    hi_f = np.concatenate([rows[:, 3:6], rows[:, 9:12]], axis=1)
    assert np.all(lo_u <= lo_f)
    assert np.all(hi_u >= hi_f)
    # one bf16 ulp at most (relative 2^-7 covers the exponent step)
    assert np.all(lo_f - lo_u <= np.maximum(np.abs(lo_f) * 2.0**-7, 1e-37))
    assert np.all(hi_u - hi_f <= np.maximum(np.abs(hi_f) * 2.0**-7, 1e-37))
    # exactly-representable values pass through unchanged
    for r in (0, 1, 2, 3):
        assert np.array_equal(lo_u[r], lo_f[r])
        assert np.array_equal(hi_u[r], hi_f[r])
    assert np.array_equal(packed[:, 6:9].view(np.int32),
                          meta.astype(np.int32))


def test_bf16_packed_traversal_matches_f32(micro_mesh):
    """bvh.PK_BF16_PACK traversal returns the exact same winners as the
    f32 rows: outward-rounded boxes only ADD subtree visits, and every
    candidate triangle's intersection is computed identically, so the
    strict-< winner per ray is unchanged. Covers the multi-cursor narrow
    path, the full-width staged path, and the octant tables."""
    from tpurt.kernels import traverse

    v, f = micro_mesh
    old = bvh.PK_BF16_PACK
    try:
        bvh.PK_BF16_PACK = False
        sc_f, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
        sc_f = sc_f.device()
        bvh.PK_BF16_PACK = True
        sc_p, _ = scene_mod.mesh_scene(1.0, v, f, use_bvh=True)
        sc_p = sc_p.device()
        assert sc_p.pk_nodes.dtype == jnp.uint32
        if traverse.OCT_ENABLE:
            assert sc_p.pk_oct_nodes.dtype == jnp.uint32
        for n in (1024, 16384):
            o, d = _rand_rays(n)
            t_max = jnp.full(n, geometry.INF)
            a = traverse.packet_nearest_tri(sc_p, o, d, t_max)
            b = traverse.packet_nearest_tri(sc_f, o, d, t_max)
            ta, na, ma, fa, ga = (np.asarray(x) for x in a)
            tb, nb, mb, fb, gb = (np.asarray(x) for x in b)
            assert np.array_equal(fa, fb)
            assert np.array_equal(ta[fb], tb[fb])
            assert np.array_equal(ga[fb], gb[fb])
            assert np.array_equal(ma[fb], mb[fb])
            assert np.array_equal(na[fb], nb[fb])
    finally:
        bvh.PK_BF16_PACK = old
