"""RenderConfig + the five BASELINE presets (SURVEY.md §5 "Config / flag
system", BASELINE.json ``configs``).

The reference parses argv into loose globals; here a frozen dataclass is the
single source of truth so the CLI, tests, benchmarks, and the eval harness
invoke identical code paths via named presets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import meshgen, scene as scene_mod
from .io import obj as obj_io


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 640
    height: int = 480
    spp: int = 1
    max_depth: int = 8
    seed: int = 0
    scene: str = "spheres_plane"      # spheres_plane | cornell | blob | obj:<path>
    mode: str = "mega"                 # primary | mega | wavefront | persist
    rr_start: Optional[int] = None     # Russian roulette from this bounce (A.8)
    spp_chunk: int = 0                 # 0 = auto (by ray-batch budget)
    # Max rays per device batch. The traversal round's serial-link term
    # is per-ROUND, nearly independent of packet count, so bigger batches
    # amortize it, until the compaction tail's volume turns at 1M. 512k
    # was chosen for BVH traversal on the previous accelerator and is not
    # yet measured on the H100 (ROADMAP A5); scenes with no BVH have no
    # link term to amortize, so render.py caps their bounce paths at
    # BRUTE_RAY_BATCH.
    ray_batch: int = 1 << 19
    shard: str = "none"                # none | tiles | spp (SURVEY.md §2 table)
    mesh_subdiv: int = 6               # blob resolution (81920 tris at 6)
    # A.5 optional vn path: interpolate OBJ-provided vertex normals at hits
    # (flat geometric shading, the decree default, when False or no vn)
    smooth: bool = False
    # A.2 optional thin-lens defocus: lens diameter in world units and the
    # in-focus plane distance. aperture 0 (the decree default, all five
    # BASELINE configs) is bit-identical to the pinhole camera.
    aperture: float = 0.0
    focus_dist: float = 1.0

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def build_scene(cfg: RenderConfig):
    """Scene-name dispatch -> (Scene, Camera). Host-side, run once."""
    if cfg.scene == "spheres_plane":
        out = scene_mod.spheres_plane(cfg.aspect)
    elif cfg.scene == "cornell":
        out = scene_mod.cornell(cfg.aspect)
    elif cfg.scene == "blob":
        v, f = meshgen.blob(subdiv=cfg.mesh_subdiv)
        out = scene_mod.mesh_scene(cfg.aspect, v, f)
    elif cfg.scene == "glassblob":
        # dielectric-bodied blob: the occupancy-decay stress workload
        # (see scene.mesh_scene body_mat)
        v, f = meshgen.blob(subdiv=cfg.mesh_subdiv)
        out = scene_mod.mesh_scene(cfg.aspect, v, f,
                                   body_mat="dielectric")
    elif cfg.scene.startswith("obj:"):
        m = obj_io.load_mesh(cfg.scene[4:])
        if cfg.smooth and not m.has_normals:
            raise ValueError(
                f"--smooth requested but {cfg.scene[4:]!r} has no vn records"
            )
        if cfg.smooth:
            out = scene_mod.mesh_scene(cfg.aspect, m.verts, m.faces,
                                       normals=m.normals,
                                       face_vn=m.face_vn)
        else:
            out = scene_mod.mesh_scene(cfg.aspect, m.verts, m.faces)
    else:
        raise ValueError(f"unknown scene {cfg.scene!r}")
    if cfg.aperture > 0.0:
        from . import camera as camera_mod
        scn, cam = out
        out = scn, camera_mod.with_lens(cam, cfg.aperture, cfg.focus_dist)
    return out


# The 5 BASELINE eval configs, frozen (resolutions the configs name; where a
# config names none, decreed here and used consistently everywhere).
PRESETS: dict[str, RenderConfig] = {
    # 1. primary-ray, built-in sphere/plane scene, Lambertian, 1 spp, 480p
    "c1-primary": RenderConfig(
        width=640, height=480, spp=1, scene="spheres_plane", mode="primary",
    ),
    # 2. full path trace, 3 materials, 64 spp, Cornell-style box, fixed seed
    "c2-cornell": RenderConfig(
        width=512, height=512, spp=64, scene="cornell", mode="mega",
        max_depth=8,
    ),
    # 3. BVH triangle mesh (bunny-class), 720p, 128 spp
    "c3-mesh": RenderConfig(
        width=1280, height=720, spp=128, scene="blob", mode="mega",
        max_depth=8,
    ),
    # 4. wavefront + compaction + Russian roulette, 1080p, 256 spp
    "c4-wavefront": RenderConfig(
        width=1920, height=1080, spp=256, scene="blob", mode="wavefront",
        max_depth=16, rr_start=3,
    ),
    # 5. multi-card tile-sharded, film allreduce accumulation, 4K, 1024 spp
    # (config names no tracer mode; megakernel measures fastest in SPMD,
    # where the wavefront's shrinking queue can't run — see mesh.py)
    "c5-multichip": RenderConfig(
        width=3840, height=2160, spp=1024, scene="blob", mode="mega",
        max_depth=16, rr_start=3, shard="tiles",
    ),
}
