"""Benchmark harness — prints ONE JSON line for the driver.

Workload: the BASELINE config-3 family (BVH-accelerated bunny-class mesh,
81,920 triangles, 720p) in megakernel mode on one GPU.
Protocol: build + compile warmup (1 sample), then time the preset's
sample count with jax.block_until_ready, best of 3 passes.

Metric: Mrays/sec per card (BASELINE.json north star: >= 100).
vs_baseline: measured value / 100 (the north-star target; the reference
publishes no numbers).

Refuses any platform but "gpu": JAX falls back to the CPU when the CUDA
plugin fails, and a CPU number must not be reported under this metric.
"""

from __future__ import annotations

import json
import time


def main() -> None:
    import jax
    import jax.numpy as jnp

    from tpurt import compile_cache, config, gpu, render

    device = gpu.require_gpu()
    card = gpu.nvidia_smi()[0]
    compile_cache.enable()

    # the c3-mesh contract preset itself (one source of truth):
    # 1280x720, blob subdiv-6, mega, depth 8, seed 0
    cfg = config.PRESETS["c3-mesh"]
    # the benched scene arrives THROUGH the OBJ loader (write -> native
    # parse -> byte-identical assert), so the bench covers BASELINE
    # config 3's "OBJ" clause at zero cost
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "benchmarks"))
    from bench_render import build_scene_obj_checked
    scene, cam = build_scene_obj_checked(cfg)
    scene = scene.device()

    # warmup: compiles the batch program (1 sample over the full frame)
    film, _ = render.render_samples(cfg, scene, cam, 0, 1)
    jax.block_until_ready(film)

    # steady state: the preset's contract sample count, best of 3 passes
    bench_spp = cfg.spp
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        film, rays = render.render_samples(cfg, scene, cam, 1,
                                           1 + bench_spp,
                                           jnp.zeros_like(film))
        jax.block_until_ready(film)
        wall = min(wall, time.perf_counter() - t0)

    value = rays / wall / 1e6   # the render runs on the default device
    print(json.dumps({
        "metric": "mrays_per_sec_per_chip",
        "value": round(value, 3),
        "unit": "Mrays/s/chip",
        "vs_baseline": round(value / 100.0, 4),
        "detail": {
            "scene": "blob-81920tris",
            "resolution": "1280x720",
            "bench_spp": bench_spp,
            "rays": int(rays),
            "wall_s": round(wall, 3),
            "spp_per_s_1080p_equiv": round(
                (bench_spp / wall) * (1280 * 720) / (1920 * 1080), 4
            ),
            "platform": device["platform"],
            "device_kind": device["kind"],
            "card": card,
        },
    }))


if __name__ == "__main__":
    main()
