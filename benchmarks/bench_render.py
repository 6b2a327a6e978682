"""Benchmark harness with JSON history (SURVEY.md §4 "Perf regression").

Runs reduced-size versions of the five BASELINE configs on one GPU (c5 on
every local card), measures steady-state throughput (compile excluded via
a warmup pass) AND image RMSE vs the NumPy oracle at a fixed
sub-resolution (the BASELINE ``metric`` is the triple Mrays/s/chip +
1080p-spp/s + RMSE, so every history record carries all three), appends
one record per run to ``benchmarks/results/history.jsonl`` (created on
first use), and — by default — fails if the metric regressed >15%
against recent runs on the same device kind. Refuses any platform but
"gpu".

Usage:
    python benchmarks/bench_render.py            # all configs, append+check
    python benchmarks/bench_render.py --quick    # config 3 only
    python benchmarks/bench_render.py --no-check # measure only
    python benchmarks/bench_render.py --no-rmse  # skip the oracle pass
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RESULTS = Path(__file__).resolve().parent / "results"

# Bench variants are the contract presets (config.PRESETS — ONE source of
# truth) with only the sample budget reduced so a full sweep stays
# minutes, not hours. Geometry/depth/mode can therefore never silently
# drift from the contract. Counts chosen on the previous accelerator to
# amortize per-call overheads; not yet re-measured on the H100.
BENCH_SPP = {
    "c1-primary": 32,
    "c2-cornell": 8,
    "c3-mesh": 4,
    "c4-wavefront": 2,
    # config 5 at bench scale: full 4K frame, reduced spp, tile-sharded
    # over every local card (the fake 8-device CPU mesh in tests)
    "c5-multichip": 8,
}
BENCH_CONFIGS = list(BENCH_SPP)  # names, preset-ordered
HEADLINE = "c3-mesh"  # the north-star scene (BVH triangle mesh)


def bench_config(name: str):
    from tpurt import config

    return config.PRESETS[name].replace(spp=BENCH_SPP[name], seed=0)


def build_scene_obj_checked(cfg):
    """build_scene for a blob config, routed THROUGH the OBJ loader.

    BASELINE config 3 names a "bunny-class OBJ" mesh; the bench scene
    is the procedural blob (no bunny file ships with the repository). To
    make the c3 bench provably cover the loader->scene->BVH path, this
    round-trips the blob through a real .obj file
    (io.obj.write_mesh, %.17g f64-exact -> load_mesh, native parse),
    asserts the loaded scene is BYTE-IDENTICAL to the direct build
    (every triangle/BVH/material array), and returns the LOADED copy —
    so the benched arrays are the loader's output, at zero throughput
    cost."""
    import os
    import tempfile

    import numpy as np

    from tpurt import config, meshgen, scene as scene_mod
    from tpurt.io import obj as obj_io

    assert cfg.scene == "blob", "OBJ round-trip targets the blob configs"
    v, f = meshgen.blob(subdiv=cfg.mesh_subdiv)
    direct, cam = scene_mod.mesh_scene(cfg.aspect, v, f)
    fd, path = tempfile.mkstemp(suffix=".obj")
    os.close(fd)
    try:
        obj_io.write_mesh(path, v, f)
        m = obj_io.load_mesh(path)
    finally:
        os.unlink(path)
    if not (np.array_equal(m.verts, np.asarray(v, np.float64))
            and np.array_equal(m.faces, np.asarray(f, np.int64))):
        raise AssertionError("OBJ round-trip: mesh arrays differ")
    loaded, cam2 = scene_mod.mesh_scene(cfg.aspect, m.verts, m.faces)
    for name in direct._fields:
        a, b = getattr(direct, name), getattr(loaded, name)
        same = (a is None and b is None) or (
            a is not None and b is not None
            and np.asarray(a).tobytes() == np.asarray(b).tobytes())
        if not same:
            raise AssertionError(f"OBJ round-trip: scene.{name} differs")
    for a, b in zip(cam, cam2):
        if np.asarray(a).tobytes() != np.asarray(b).tobytes():
            raise AssertionError("OBJ round-trip: camera differs")
    return loaded, cam2

# RMSE probe: same scene/physics at a fixed small frame so the NumPy
# oracle finishes in seconds; records parity for every bench config.
RMSE_W, RMSE_H, RMSE_SPP = 96, 54, 2


def rmse_vs_oracle(cfg) -> float:
    from tpurt import config, cpu_ref, film as film_mod, mesh, render

    cfg = cfg.replace(width=RMSE_W, height=RMSE_H,
                      spp=min(RMSE_SPP, cfg.spp))
    scene, cam = config.build_scene(cfg)
    if cfg.shard != "none":
        f_dev, _ = mesh.render_sharded(cfg, scene, cam)
    else:
        f_dev, _ = render.render(cfg, scene, cam)
    f_ref, _ = cpu_ref.render(cfg, scene.device(), cam)
    return float(film_mod.rmse(f_dev, f_ref))


def run_one(name: str, with_rmse: bool = True, retry: bool = False) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpurt import config, gpu, mesh, render

    device = gpu.require_gpu()
    card = gpu.nvidia_smi()[0]

    cfg = bench_config(name)
    if name == HEADLINE:
        # the headline scene arrives through the OBJ loader (byte-
        # identical round-trip assert — BASELINE config 3's OBJ clause)
        scene, cam = build_scene_obj_checked(cfg)
    else:
        scene, cam = config.build_scene(cfg)

    # Timing protocol: REPS timed passes after a warmup, each ended by a
    # device sync; the BEST pass is the gate statistic (see
    # gate_failures) and the MEDIAN is recorded alongside.
    REPS = 7 if name == "c5-multichip" else 5
    walls: list[float] = []
    if cfg.shard != "none":
        m = mesh.make_mesh()
        # warmup: compile + 1 sample over the mesh
        film, _ = mesh.render_samples_sharded(cfg, scene, cam, 0, 1, mesh=m)
        for _ in range(REPS):
            t0 = time.perf_counter()
            film, rays = mesh.render_samples_sharded(
                cfg, scene, cam, 1, 1 + cfg.spp,
                np.zeros_like(film), mesh=m,
            )  # returns a host array: already synced
            walls.append(time.perf_counter() - t0)
        devices = m.size
    else:
        scene = scene.device()
        # warmup: compile + 1 sample
        film, _ = render.render_samples(cfg, scene, cam, 0, 1)
        jax.block_until_ready(film)
        for _ in range(REPS):
            t0 = time.perf_counter()
            film, rays = render.render_samples(
                cfg, scene, cam, 1, 1 + cfg.spp, jnp.zeros_like(film))
            jax.block_until_ready(film)
            walls.append(time.perf_counter() - t0)
        devices = 1
    wall = min(walls)
    wall_median = sorted(walls)[len(walls) // 2]

    from tpurt import metrics

    stats = metrics.build_stats(rays, wall, cfg.width, cfg.height, cfg.spp,
                                devices=devices)
    rec = {
        "name": name,
        "ts": round(time.time(), 1),
        # the gate compares records of the same device kind only
        "backend": f"{jax.default_backend()}:{device['kind']}",
        "device_kind": device["kind"],
        "card": card,
        "mrays_per_s": round(stats["mrays_per_s"], 3),
        "mrays_per_s_per_chip": round(stats["mrays_per_s"] / devices, 3),
        "spp_per_s_1080p": round(stats["spp_per_s_1080p"], 4),
        "rays": stats["rays"],
        "wall_s": round(wall, 3),
        "wall_median_s": round(wall_median, 3),
        "mrays_median": round(stats["mrays_per_s"] * wall / wall_median, 3),
        "devices": devices,
        "config": {"preset": name, "spp": cfg.spp},
    }
    if retry:
        rec["retry"] = True
    if with_rmse:
        rec["rmse_vs_oracle"] = round(rmse_vs_oracle(cfg), 6)
    print(json.dumps(rec), flush=True)
    return rec


GATE_MARGIN = 0.85
GATE_WINDOW = 5


def gate_failures(records: list[dict], history: list[dict],
                  margin: float = GATE_MARGIN,
                  window: int = GATE_WINDOW) -> list[str]:
    """Noise-robust regression gate.

    Run-to-run noise in wall time is one-sided — it only ever adds time —
    so BEST-of-reps is a consistent estimator of device speed. The gate
    compares each record's best (``mrays_per_s``) against the MEDIAN of
    the last `window` prior bests on the same backend and device kind
    (window-median, never all-time, so one lucky outlier cannot gate
    later runs). A genuine 20% slowdown slows every rep including the
    best, so it still trips (0.8 < 0.85); a multimodal sweep only fails
    when ALL reps miss the fast mode, which extra c5 reps + the automatic
    solo retry in main() (see run_gate_with_retry) make vanishingly rare
    — asserted statistically in tests/test_bench_gate.py.

    Returns a list of human-readable failure strings (empty = pass).
    """
    fails = []
    for rec in records:
        prior = [h for h in history
                 if h["name"] == rec["name"]
                 and h["backend"] == rec["backend"]
                 and h["ts"] < rec["ts"]]
        vals = [h["mrays_per_s"] for h in prior[-window:]]
        if not vals:
            continue
        ref = sorted(vals)[len(vals) // 2]
        now = rec["mrays_per_s"]
        if now < margin * ref:
            fails.append(
                f"REGRESSION: {rec['name']} best {now} < "
                f"{margin} * recent-median-of-bests {ref}")
    return fails


def run_gate_with_retry(records, history, run_fn,
                        margin: float = GATE_MARGIN,
                        window: int = GATE_WINDOW):
    """Gate with ONE automatic solo re-run per failing config. A fresh
    solo record whose best
    clears the gate supersedes the tripped sweep record (both go to
    history; the retry is flagged). A retry that STILL fails is a real
    regression.

    run_fn(name) -> record. Returns (extra_records, fails).
    """
    extra, remaining = [], []
    for rec in records:
        if not gate_failures([rec], history, margin, window):
            continue
        retry_rec = run_fn(rec["name"])
        extra.append(retry_rec)
        remaining.extend(gate_failures([retry_rec], history + [retry_rec],
                                       margin, window))
    return extra, remaining


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--check", dest="check", action="store_true",
                    default=True,
                    help="exit 1 if a config regresses >15%% vs recent runs "
                         "(DEFAULT; see --no-check)")
    ap.add_argument("--no-check", dest="check", action="store_false")
    ap.add_argument("--no-rmse", dest="rmse", action="store_false",
                    default=True)
    ap.add_argument("--configs", nargs="*", default=None)
    args = ap.parse_args()

    names = ([HEADLINE] if args.quick else
             args.configs or BENCH_CONFIGS)
    RESULTS.mkdir(parents=True, exist_ok=True)
    hist_path = RESULTS / "history.jsonl"

    records = [run_one(n, with_rmse=args.rmse) for n in names]
    with open(hist_path, "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")

    if args.check:
        history = [json.loads(line) for line in open(hist_path)]
        extra, fails = run_gate_with_retry(
            records, history,
            lambda n: run_one(n, with_rmse=args.rmse, retry=True))
        with open(hist_path, "a") as f:
            for r in extra:
                f.write(json.dumps(r) + "\n")
        for f_ in fails:
            print(f_, file=sys.stderr)
        if fails:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
