"""The native SAH split must be BIT-IDENTICAL to the NumPy reference —
the BVH topology feeds byte-exact golden images, so this is an equality
contract, not a tolerance (SURVEY.md §4 Property row discipline)."""

import os

import numpy as np
import pytest

from tpurt import bvh, native


def _numpy_partition(idx, tlo, thi, centroid):
    """Call the checked-in NumPy implementation directly (it is the
    reference the port is pinned against)."""
    return bvh._sah_partition(idx, tlo, thi, centroid)


def _soups(rs):
    # generic random soup
    v0 = rs.uniform(-5, 5, (4096, 3)).astype(np.float32)
    yield v0, v0 + rs.uniform(0, 1, (4096, 3)).astype(np.float32), \
        v0 + rs.uniform(0, 1, (4096, 3)).astype(np.float32)
    # clustered (exercises degenerate/one-bin paths)
    base = rs.uniform(-1, 1, (1, 3)).astype(np.float32)
    v0 = np.repeat(base, 512, axis=0)
    yield v0, v0 + 1e-7, v0 + 2e-7
    # axis-aligned plane of centroids (flat extents on two axes)
    v0 = np.zeros((777, 3), np.float32)
    v0[:, 0] = rs.uniform(0, 9, 777).astype(np.float32)
    yield v0, v0 + 0.5, v0 + 0.25
    # duplicated centroids with distinct boxes (tie resolution)
    v0 = np.tile(rs.uniform(-2, 2, (16, 3)).astype(np.float32), (64, 1))
    yield v0, v0 + rs.uniform(0, 2, (1024, 3)).astype(np.float32), v0 + 0.1


@pytest.mark.skipif(not native.available(),
                    reason="native SAH unavailable (no g++)")
def test_native_partition_bit_identical_to_numpy():
    rs = np.random.RandomState(11)
    cases = 0
    for v0, v1, v2 in _soups(rs):
        tlo = np.minimum(np.minimum(v0, v1), v2)
        thi = np.maximum(np.maximum(v0, v1), v2)
        centroid = (tlo + thi) * np.float32(0.5)
        n = v0.shape[0]
        for idx in (np.arange(n, dtype=np.int64),
                    rs.permutation(n).astype(np.int64),
                    rs.permutation(n)[: n // 3].astype(np.int64)):
            ln, rn, an = _numpy_partition(idx, tlo, thi, centroid)
            res = native.sah_partition(idx, tlo, thi, centroid,
                                       bvh.SAH_BINS)
            assert res is not None
            lc, rc, ac = res
            assert ac == an, (cases, ac, an)
            assert np.array_equal(lc, ln), cases
            assert np.array_equal(rc, rn), cases
            cases += 1
    assert cases >= 12


@pytest.mark.skipif(not native.available(),
                    reason="native SAH unavailable (no g++)")
def test_native_build_arrays_bit_identical():
    """Whole-build equality on a real mesh: every output array of all
    three builders must be byte-identical with the native split on and
    off (this is what keeps the golden images valid)."""
    from tpurt import config
    from tpurt.kernels import traverse

    cfg = config.RenderConfig(width=8, height=8, spp=1, scene="blob",
                              mesh_subdiv=3)
    # cover the pk8 layout too (built only when WIDE_ENABLE asks)
    old_wide = traverse.WIDE_ENABLE
    traverse.WIDE_ENABLE = True
    try:
        scene_nat, _ = config.build_scene(cfg)
        assert scene_nat.pk8_nodes is not None

        # force the NumPy fallback for the second build: TPURT_NATIVE=0
        # is only consulted at load time, so the cached lib must be
        # dropped BOTH ways (poking only a cached flag would leave the
        # native path live and make this test vacuous)
        os.environ["TPURT_NATIVE"] = "0"
        native._libs.clear()
        try:
            assert not native.available("sah")
            scene_np, _ = config.build_scene(cfg)
        finally:
            del os.environ["TPURT_NATIVE"]
            native._libs.clear()
    finally:
        traverse.WIDE_ENABLE = old_wide

    for name in ("bvh_lo", "bvh_hi", "bvh_skip", "bvh_first", "bvh_count",
                 "tri_v0", "tri_e1", "tri_e2", "tri_mat", "tri_src",
                 "pk_nodes", "pk_leaves", "pk_cut",
                 "pk8_nodes", "pk8_leaves", "pk8_cut"):
        a = getattr(scene_nat, name)
        b = getattr(scene_np, name)
        assert (a is None) == (b is None), name
        if a is not None:
            # byte compare: packet-node rows hold int32 metadata bitcast
            # into f32 slots, which reads as NaN and defeats array_equal
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), name
