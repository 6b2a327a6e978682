"""SoA scene pytree + built-in scenes (SURVEY.md §1 L8, §2 "Scene").

The reference keeps heterogeneous primitive lists walked per ray; here the
scene is a struct-of-arrays NamedTuple (a JAX pytree) so one intersection
call tests a whole ray batch against whole primitive tables. Arrays are
host NumPy until ``device()`` puts them in HBM.

Empty primitive classes are padded with one inert element (zero-radius
sphere / zero-normal plane / degenerate triangle — each provably un-hittable
by the guarded tests in geometry.py) so every scene has the same pytree
structure and static shapes per scene.

Material encoding (A.6–A.7): type 0 lambertian / 1 metal(fuzz) /
2 dielectric(ior) / 3 emissive (adds emission, terminates the path).

Sky (A.7) is data, not control flow: ``sky(d) = lerp(sky_a, sky_b,
0.5*(dy+1))``; the Cornell scene sets both colors to zero instead of
branching on a "has sky" flag.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import numpy as np

from . import bvh as bvh_mod
from .camera import Camera, make_camera

LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3


class Scene(NamedTuple):
    # spheres
    sph_c: np.ndarray     # (S,3)
    sph_r: np.ndarray     # (S,)
    sph_mat: np.ndarray   # (S,) i32
    # infinite planes n·x = k (unit normals)
    pln_n: np.ndarray     # (P,3)
    pln_k: np.ndarray     # (P,)
    pln_mat: np.ndarray   # (P,) i32
    # triangle soup (leaf-padded order when a BVH is attached)
    tri_v0: np.ndarray    # (T,3)
    tri_e1: np.ndarray    # (T,3)
    tri_e2: np.ndarray    # (T,3)
    tri_mat: np.ndarray   # (T,) i32
    # material tables
    mat_type: np.ndarray    # (M,) i32
    mat_albedo: np.ndarray  # (M,3)
    mat_fuzz: np.ndarray    # (M,)
    mat_ior: np.ndarray     # (M,)
    mat_emit: np.ndarray    # (M,3)
    # packed per-material row [type_bits, alb.rgb, emit.rgb, fuzz, ior,
    # 0..] (M,16) f32 — the bounce loop gathers material params in ONE
    # N-row gather instead of five
    mat_packed: np.ndarray  # (M,16) f32
    # sky gradient endpoints (A.7); zeros => black background
    sky_a: np.ndarray     # (3,) color at horizon (t=0)
    sky_b: np.ndarray     # (3,) color at zenith (t=1)
    # optional flattened BVH node arrays (triangles above are its soup)
    bvh_lo: Optional[np.ndarray]     # (B,3)
    bvh_hi: Optional[np.ndarray]     # (B,3)
    bvh_skip: Optional[np.ndarray]   # (B,) i32
    bvh_first: Optional[np.ndarray]  # (B,) i32
    bvh_count: Optional[np.ndarray]  # (B,) i32
    # optional packet-traversal layout (bvh.PacketBVH; the device fast path)
    pk_nodes: Optional[np.ndarray]   # (M,16) f32
    pk_leaves: Optional[np.ndarray]  # (L, PACKET_LEAF_N*LEAF_F) f32
    pk_cut: Optional[np.ndarray]     # (8,2) i32 subtree cut (bvh.PacketBVH)
    # optional wide-fanout (8-ary) packet layout (bvh.PacketBVH8) —
    # built alongside the binary layout; the traversal uses it only when
    # kernels.traverse.WIDE_ENABLE is set (it lost under the walk-gated
    # round regime; kept for regimes where shorter walks pay)
    pk8_nodes: Optional[np.ndarray]  # (Mw,64) f32
    pk8_leaves: Optional[np.ndarray]  # (L, PACKET_LEAF_N*LEAF_F) f32
    pk8_cut: Optional[np.ndarray]    # (8,2) i32 subtree cut
    # optional vn shading normals (A.5): one 32-f32 row per ORIGINAL
    # triangle [n0.xyz, n1.xyz, n2.xyz, v0.xyz, e1.xyz, e2.xyz, 14 pad] —
    # everything the winner-gid interpolation needs in ONE row gather
    tri_shn: Optional[np.ndarray]    # (T0,32) f32
    # padded-soup slot -> original triangle index (-1 padding); present
    # whenever a binary BVH is attached (feeds the per-ray oracle's gid)
    tri_src: Optional[np.ndarray]    # (Tp,) i32
    # optional octant-ordered packet tables (bvh.PacketBVH.oct_nodes
    # flattened to one gather array; kernels.traverse.OCT_ENABLE) — the
    # 8 front-to-back re-flattens share pk_leaves; octant o's rows live
    # at [o*Mi, (o+1)*Mi)
    pk_oct_nodes: Optional[np.ndarray] = None   # (8*Mi, 16) f32
    pk_oct_cut: Optional[np.ndarray] = None     # (8, 8, 2) i32

    @property
    def has_bvh(self) -> bool:
        return self.bvh_lo is not None

    def device(self) -> "Scene":
        return jax.device_put(self)


class SceneBuilder:
    """Imperative assembly -> immutable SoA Scene."""

    def __init__(self, sky: bool = True):
        self._sph = []
        self._pln = []
        self._tri = []   # (v0, v1, v2, mat)
        self._mat = []
        if sky:
            self.sky_a = np.array([1.0, 1.0, 1.0], np.float32)
            self.sky_b = np.array([0.5, 0.7, 1.0], np.float32)
        else:
            self.sky_a = np.zeros(3, np.float32)
            self.sky_b = np.zeros(3, np.float32)

    # -- materials ---------------------------------------------------------
    def material(self, mtype: int, albedo=(0, 0, 0), fuzz: float = 0.0,
                 ior: float = 1.5, emit=(0, 0, 0)) -> int:
        self._mat.append((mtype, albedo, fuzz, ior, emit))
        return len(self._mat) - 1

    def lambertian(self, albedo) -> int:
        return self.material(LAMBERTIAN, albedo)

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        return self.material(METAL, albedo, fuzz=fuzz)

    def dielectric(self, ior: float = 1.5) -> int:
        return self.material(DIELECTRIC, (1, 1, 1), ior=ior)

    def emissive(self, emit) -> int:
        return self.material(EMISSIVE, emit=emit)

    # -- primitives ----------------------------------------------------------
    def sphere(self, center, radius: float, mat: int) -> None:
        self._sph.append((center, radius, mat))

    def plane(self, normal, k: float, mat: int) -> None:
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._pln.append((n, k, mat))

    def triangle(self, v0, v1, v2, mat: int, normals=None) -> None:
        """normals (optional): (3,3) per-vertex unit shading normals (A.5
        vn path); None = flat geometric shading for this triangle."""
        self._tri.append((v0, v1, v2, mat, normals))

    def quad(self, corner, edge_u, edge_v, mat: int) -> None:
        """Parallelogram corner + edge_u + edge_v as two triangles."""
        c = np.asarray(corner, np.float64)
        eu = np.asarray(edge_u, np.float64)
        ev = np.asarray(edge_v, np.float64)
        self.triangle(c, c + eu, c + eu + ev, mat)
        self.triangle(c, c + eu + ev, c + ev, mat)

    def mesh(self, vertices, faces, mat: int,
             normals=None, face_vn=None) -> None:
        """normals (VN,3) + face_vn (F,3) — per-corner vn indices from an
        OBJ (io/obj.Mesh); both None = flat shading (the A.5 default)."""
        v = np.asarray(vertices, np.float64)
        fc = np.asarray(faces, np.int64)
        if normals is not None and face_vn is not None:
            nrm = np.asarray(normals, np.float64)
            fvn = np.asarray(face_vn, np.int64)
            for f, fn in zip(fc, fvn):
                self.triangle(v[f[0]], v[f[1]], v[f[2]], mat,
                              normals=nrm[fn])
        else:
            for f in fc:
                self.triangle(v[f[0]], v[f[1]], v[f[2]], mat)

    # -- build ---------------------------------------------------------------
    def build(self, use_bvh: Optional[bool] = None) -> Scene:
        if not self._mat:
            self.lambertian((0.5, 0.5, 0.5))
        if use_bvh is None:
            use_bvh = len(self._tri) > 64

        if self._sph:
            sph_c = np.asarray([s[0] for s in self._sph], np.float32)
            sph_r = np.asarray([s[1] for s in self._sph], np.float32)
            sph_m = np.asarray([s[2] for s in self._sph], np.int32)
        else:  # inert: zero radius can never satisfy disc > 0
            sph_c = np.zeros((1, 3), np.float32)
            sph_r = np.zeros((1,), np.float32)
            sph_m = np.zeros((1,), np.int32)

        if self._pln:
            pln_n = np.asarray([p[0] for p in self._pln], np.float32)
            pln_k = np.asarray([p[1] for p in self._pln], np.float32)
            pln_m = np.asarray([p[2] for p in self._pln], np.int32)
        else:  # inert: zero normal -> |denom| <= 1e-8 always
            pln_n = np.zeros((1, 3), np.float32)
            pln_k = np.zeros((1,), np.float32)
            pln_m = np.zeros((1,), np.int32)

        tri_shn = None
        if self._tri:
            tv0 = np.asarray([t[0] for t in self._tri], np.float32)
            tv1 = np.asarray([t[1] for t in self._tri], np.float32)
            tv2 = np.asarray([t[2] for t in self._tri], np.float32)
            tm = np.asarray([t[3] for t in self._tri], np.int32)
            if any(t[4] is not None for t in self._tri):
                # triangles without vn fall back to their geometric normal
                # (interpolation then reproduces flat shading exactly)
                geo = np.cross(tv1 - tv0, tv2 - tv0)
                geo /= np.maximum(
                    np.linalg.norm(geo, axis=-1, keepdims=True), 1e-12)
                tri_shn = np.zeros((len(self._tri), 32), np.float32)
                for i, t in enumerate(self._tri):
                    ns = np.broadcast_to(geo[i], (3, 3)) if t[4] is None \
                        else np.asarray(t[4], np.float64)
                    tri_shn[i, 0:9] = np.asarray(ns, np.float32).reshape(9)
                tri_shn[:, 9:12] = tv0
                tri_shn[:, 12:15] = tv1 - tv0
                tri_shn[:, 15:18] = tv2 - tv0
        else:  # inert: zero edges -> |det| <= TRI_EPS always
            tv0 = np.zeros((1, 3), np.float32)
            tv1 = np.zeros((1, 3), np.float32)
            tv2 = np.zeros((1, 3), np.float32)
            tm = np.zeros((1,), np.int32)
            use_bvh = False

        blo = bhi = bskip = bfirst = bcount = None
        pk_nodes = pk_leaves = pk_cut = None
        pk8_nodes = pk8_leaves = pk8_cut = None
        tri_src = None
        pk_oct_nodes = pk_oct_cut = None
        if use_bvh:
            # octant tables ride the same build when the traversal flag
            # asks for them (same contract as WIDE_ENABLE below); the
            # base table is octant 0, bit-identical either way
            from .kernels import traverse as _trav_oct
            pk = bvh_mod.build_packet(tv0, tv1, tv2, tm,
                                      octants=_trav_oct.OCT_ENABLE)
            pk_nodes, pk_leaves, pk_cut = pk.nodes, pk.leaves, pk.cut
            if pk.oct_nodes is not None:
                pk_oct_nodes = pk.oct_nodes.reshape(-1, 16)
                pk_oct_cut = pk.oct_cut
            if bvh_mod.PK_BF16_PACK:
                # bf16-packed node rows (bvh.pack_nodes_bf16): traversal
                # branches on the u32 dtype; boxes only get looser, so
                # the cull stays conservative and goldens byte-identical
                pk_nodes = bvh_mod.pack_nodes_bf16(pk_nodes)
                if pk_oct_nodes is not None:
                    pk_oct_nodes = bvh_mod.pack_nodes_bf16(pk_oct_nodes)
            # The wide (8-ary) layout is off in production
            # (kernels.traverse.WIDE_ENABLE): building it eagerly is a
            # third full SAH recursion plus an (Mw,64) device upload per
            # scene for arrays the traversal never reads. Built only when
            # the flag asks for it; callers that flip WIDE_ENABLE set it
            # BEFORE building their scene.
            from .kernels import traverse as _traverse
            if _traverse.WIDE_ENABLE:
                pk8 = bvh_mod.build_packet8(tv0, tv1, tv2, tm)
                pk8_nodes, pk8_leaves, pk8_cut = (
                    pk8.nodes, pk8.leaves, pk8.cut)
            tree = bvh_mod.build(tv0, tv1, tv2, tm)
            # the BVH's leaf-padded soup replaces the raw soup so brute and
            # BVH paths intersect identical triangle tables
            tri_v0, tri_e1, tri_e2, tri_m = (
                tree.tri_v0, tree.tri_e1, tree.tri_e2, tree.tri_mat,
            )
            tri_src = tree.tri_src
            blo, bhi = tree.lo, tree.hi
            bskip, bfirst, bcount = tree.skip, tree.first, tree.count
        else:
            tri_v0 = tv0
            tri_e1 = tv1 - tv0
            tri_e2 = tv2 - tv0
            tri_m = tm
            if tri_shn is not None:
                tri_src = np.arange(tv0.shape[0], dtype=np.int32)

        mat_t = np.asarray([m[0] for m in self._mat], np.int32)
        mat_a = np.asarray([m[1] for m in self._mat], np.float32)
        mat_f = np.asarray([m[2] for m in self._mat], np.float32)
        mat_i = np.asarray([m[3] for m in self._mat], np.float32)
        mat_e = np.asarray([m[4] for m in self._mat], np.float32)
        mp = np.zeros((mat_t.shape[0], 16), np.float32)
        mp[:, 0] = mat_t.view(np.float32)
        mp[:, 1:4] = mat_a
        mp[:, 4:7] = mat_e
        mp[:, 7] = mat_f
        mp[:, 8] = mat_i

        return Scene(
            sph_c=sph_c, sph_r=sph_r, sph_mat=sph_m,
            pln_n=pln_n, pln_k=pln_k, pln_mat=pln_m,
            tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2, tri_mat=tri_m,
            mat_type=mat_t, mat_albedo=mat_a, mat_fuzz=mat_f,
            mat_ior=mat_i, mat_emit=mat_e, mat_packed=mp,
            sky_a=self.sky_a, sky_b=self.sky_b,
            bvh_lo=blo, bvh_hi=bhi, bvh_skip=bskip,
            bvh_first=bfirst, bvh_count=bcount,
            pk_nodes=pk_nodes, pk_leaves=pk_leaves, pk_cut=pk_cut,
            pk8_nodes=pk8_nodes, pk8_leaves=pk8_leaves, pk8_cut=pk8_cut,
            tri_shn=tri_shn, tri_src=tri_src,
            pk_oct_nodes=pk_oct_nodes, pk_oct_cut=pk_oct_cut,
        )


# ---------------------------------------------------------------------------
# Built-in scenes — one per BASELINE config family (SURVEY.md Appendix A.12).
# Constants are frozen by the golden tests.
# ---------------------------------------------------------------------------

def spheres_plane(aspect: float) -> tuple[Scene, Camera]:
    """Config 1: ground plane + four spheres under the gradient sky."""
    b = SceneBuilder(sky=True)
    ground = b.lambertian((0.5, 0.5, 0.5))
    red = b.lambertian((0.7, 0.3, 0.3))
    green = b.lambertian((0.3, 0.9, 0.4))
    mirror = b.metal((0.8, 0.8, 0.8), fuzz=0.05)
    glass = b.dielectric(1.5)
    b.plane((0, 1, 0), 0.0, ground)
    b.sphere((0, 1, 0), 1.0, red)
    b.sphere((-2.2, 1, 0), 1.0, mirror)
    b.sphere((2.2, 1, 0), 1.0, glass)
    b.sphere((0.9, 0.35, 1.4), 0.35, green)
    cam = make_camera((0, 1.6, 5.5), (0, 1, 0), (0, 1, 0), 50.0, aspect)
    return b.build(), cam


def cornell(aspect: float) -> tuple[Scene, Camera]:
    """Config 2: Cornell-style box (quads), area light, all three materials."""
    b = SceneBuilder(sky=False)
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.emissive((15.0, 15.0, 15.0))
    mirror = b.metal((0.9, 0.9, 0.9), fuzz=0.08)
    glass = b.dielectric(1.5)

    # box interior: x,z in [-1,1], y in [0,2]
    b.quad((-1, 0, -1), (2, 0, 0), (0, 0, 2), white)    # floor
    b.quad((-1, 2, -1), (0, 0, 2), (2, 0, 0), white)    # ceiling
    b.quad((-1, 0, -1), (0, 2, 0), (2, 0, 0), white)    # back wall z=-1
    b.quad((-1, 0, -1), (0, 0, 2), (0, 2, 0), red)      # left wall x=-1
    b.quad((1, 0, -1), (0, 2, 0), (0, 0, 2), green)     # right wall x=+1
    b.quad((-0.4, 1.999, -0.4), (0.8, 0, 0), (0, 0, 0.8), light)
    b.sphere((-0.45, 0.35, 0.1), 0.35, mirror)
    b.sphere((0.45, 0.35, -0.25), 0.35, glass)
    cam = make_camera((0, 1.0, 3.2), (0, 1.0, 0), (0, 1, 0), 40.0, aspect)
    return b.build(use_bvh=False), cam


def mesh_scene(aspect: float, vertices, faces, use_bvh: bool = True,
               normals=None, face_vn=None,
               body_mat: str = "lambertian") -> tuple[Scene, Camera]:
    """Config 3 family: a triangle mesh on a ground plane, metal + glass
    companions, gradient sky. Camera auto-framed from the mesh bounds.

    body_mat: "lambertian" (default, frozen by goldens) or "dielectric" —
    the glass-bodied variant is the occupancy-decay stress workload for
    the mega-vs-wavefront comparison (BASELINE config 4's raison d'être:
    dielectrics never absorb, so paths run deep and Russian roulette
    kills lanes stochastically — the regime where queue shrinkage should
    beat dead-lane masking)."""
    b = SceneBuilder(sky=True)
    ground = b.lambertian((0.45, 0.45, 0.45))
    if body_mat == "dielectric":
        body = b.dielectric(1.5)
    else:
        body = b.lambertian((0.75, 0.55, 0.35))
    mirror = b.metal((0.85, 0.85, 0.9), fuzz=0.02)
    glass = b.dielectric(1.5)

    v = np.asarray(vertices, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    extent = float((hi - lo).max())
    b.plane((0, 1, 0), float(lo[1]), ground)
    b.mesh(v, faces, body, normals=normals, face_vn=face_vn)
    b.sphere(center + np.array([-0.9, 0.05, 0.35]) * extent,
             0.3 * extent, mirror)
    b.sphere(center + np.array([0.9, 0.05, -0.15]) * extent,
             0.3 * extent, glass)

    eye = center + np.array([0.0, 0.55, 2.2]) * extent
    cam = make_camera(tuple(eye), tuple(center), (0, 1, 0), 38.0, aspect)
    return b.build(use_bvh=use_bvh), cam
