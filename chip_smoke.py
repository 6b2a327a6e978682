"""Smoke test of the path tracer on an NVIDIA GPU.

    python chip_smoke.py                # one card: every single-card phase
    python chip_smoke.py --four-card    # only the c5-multichip phase, 4 cards

It drives the main path through the user's entry point
(``tpurt.cli.main``) at the presets' full resolutions and checks the
result against the NumPy oracle (``tpurt/cpu_ref.py``). Phases, one line
each:

  device       platform must be "gpu" (JAX falls back to the CPU when the
               CUDA plugin fails, and a CPU run must never print ok); the
               card's name and power limit from nvidia-smi
  c3-mesh      the main path: 1280x720, 81,920-triangle BVH mesh, mode
               mega, depth 8, cold then warm: scene build seconds, whether
               the native SAH builder loaded, compile and steady-state
               seconds, rays and Mrays/s
  c1/c2/c4     the other single-card presets at full resolution, 1-2 spp
  determinism  c3-mesh rendered twice in one process, films compared
               byte for byte (c4-wavefront's two PPMs as well)
  parity       each preset's full-size device film against cpu_ref on a
               96x54 grid of its pixels (RNG streams are keyed by pixel id,
               so the oracle renders exactly those pixels)
  denormals    whether the card flushes f32 denormals, and the --smooth
               icosphere fixture (vn interpolation) against the oracle

With --four-card only c5-multichip runs: 4K, shard="tiles" on a 4-card
mesh against the same render on a 1-card mesh, and shard="spp" on 4 cards
against it too, with wall times and scaling efficiency.

A failing phase raises, so the process exits non-zero and prints no
result. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Samples per pixel of each single-card phase. The presets' contract
# counts (64-256 spp) take far longer than a smoke run; the images and
# programs are the same at any count.
SMOKE_SPP = {"c3-mesh": 4, "c1-primary": 2, "c2-cornell": 2,
             "c4-wavefront": 1}
FOUR_CARD_SPP = 4       # shard="spp" needs a multiple of the card count

# Parity: the oracle renders a PARITY_GRID (columns, rows) lattice of
# each frame's pixels.
PARITY_GRID = (96, 54)
# A pixel channel may move by PARITY_LEVEL tonemapped levels where float
# rounding lands on a quantization edge.
PARITY_LEVEL = 1
# At most this share of the sampled pixels may move by more: FMA
# contraction and another reduction order can flip an isolated path at
# an f32 branch edge (a grazing hit, a Fresnel or Russian-roulette
# threshold), and each flip moves only its own pixel. A systematic fault
# (wrong normal, material or RNG stream) moves most pixels.
PARITY_FRAC = 0.01
# Linear-film RMSE of the other pixels (those within PARITY_LEVEL) at
# most this share of the reference film's RMS. A flipped path may move
# its pixel far (one that reaches the Cornell light, emission 15), so the
# flips are bounded by PARITY_FRAC alone; what is left differs only by
# rounding, and the card reads 0 to 3e-6 here. A lower-precision path or
# a dropped term shifts it across the frame by far more.
PARITY_RMSE_REL = 1e-3
# shard="spp" psums the cards' sample sums in another order than one card
# adds them, and its packets are scanline strips instead of 16x8 tiles,
# which can flip a winner only on an exact f32 t-tie.
SPP_SHARD_FRAC = 1e-4
SPP_SHARD_RMSE = 1e-4

VN_FIXTURE = REPO / "tests" / "fixtures" / "icosphere_vn.obj"


class SmokeError(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(line: str) -> None:
    print(line, flush=True)


def parity_pixels(width: int, height: int) -> np.ndarray:
    """Flat ids of a PARITY_GRID lattice spread over the whole frame."""
    gx, gy = PARITY_GRID
    xs = np.linspace(0, width - 1, gx).round().astype(np.int64)
    ys = np.linspace(0, height - 1, gy).round().astype(np.int64)
    return (ys[:, None] * width + xs[None, :]).reshape(-1)


def compare_films(dev, ref) -> dict:
    """Linear RMSE and tonemapped pixel differences of two films of the
    same pixels (any shape with a trailing RGB axis)."""
    from tpurt import film as film_mod

    dev = np.asarray(dev, np.float32).reshape(-1, 3)
    ref = np.asarray(ref, np.float32).reshape(-1, 3)
    require(dev.shape == ref.shape, f"film shapes {dev.shape} {ref.shape}")
    diff = np.abs(film_mod.tonemap(dev).astype(np.int32)
                  - film_mod.tonemap(ref).astype(np.int32)).max(axis=-1)
    rms_ref = max(float(np.sqrt(np.mean(np.asarray(ref, np.float64) ** 2))),
                  1e-12)
    inl = diff <= PARITY_LEVEL
    return {
        "rmse": film_mod.rmse(dev, ref),
        "rmse_rel": film_mod.rmse(dev, ref) / rms_ref,
        "rmse_inlier_rel": (film_mod.rmse(dev[inl], ref[inl]) / rms_ref
                            if inl.any() else np.inf),
        "frac_px_differ": float((diff > 0).mean()),
        "frac_px_over_level": float((diff > PARITY_LEVEL).mean()),
        "max_dev": int(diff.max()),
        "finite": bool(np.isfinite(dev).all()),
        "byte_identical": dev.tobytes() == ref.tobytes(),
    }


def parity_ok(r: dict) -> bool:
    return (r["finite"] and r["frac_px_over_level"] <= PARITY_FRAC
            and r["rmse_inlier_rel"] <= PARITY_RMSE_REL)


def fmt(r: dict) -> str:
    return (f"rmse={r['rmse']:.3e} rmse_rel={r['rmse_rel']:.3e} "
            f"rmse_inlier_rel={r['rmse_inlier_rel']:.3e} "
            f"px_differ={r['frac_px_differ']:.5f} "
            f"px_over_{PARITY_LEVEL}={r['frac_px_over_level']:.5f} "
            f"max_dev={r['max_dev']} byte_identical={r['byte_identical']}")


def run_cli(argv: list[str]) -> tuple[dict, dict]:
    """One in-process ``tpurt.cli.main`` render; returns its stats line
    and its scene event."""
    from tpurt import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    require(rc == 0, f"cli.main({argv}) returned {rc}")
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    scene = {}
    for ln in err.getvalue().splitlines():
        if ln.startswith("{") and '"event": "scene"' in ln:
            scene = json.loads(ln)
        else:
            print(ln, file=sys.stderr)
    return stats, scene


def phase_preset(name: str, out_dir: Path) -> dict:
    """Cold and warm CLI renders of one preset at full resolution."""
    from tpurt import native

    spp = SMOKE_SPP[name]
    runs = []
    for tag in ("cold", "warm"):
        ppm = out_dir / f"{name}-{tag}.ppm"
        stats, scene = run_cli(["render", "--preset", name, "--spp",
                                str(spp), "--out", str(ppm)])
        require(stats["backend"] == "gpu", f"{name}: ran on {stats}")
        require(stats["rays"] > 0, f"{name}: no rays cast")
        runs.append((stats, scene, ppm.read_bytes()))
    (cold, scene, ppm_cold), (warm, _, ppm_warm) = runs
    require(cold["rays"] == warm["rays"],
            f"{name}: rays {cold['rays']} != {warm['rays']}")
    cfg = cold["config"]
    res = {
        "name": name, "spp": spp, "rays": warm["rays"],
        "build_s": scene["build_s"],
        "triangles": scene.get("mesh_triangles", scene["triangles"]),
        "native_sah": native.available("sah"),
        "cold_s": cold["wall_s"], "run_s": warm["wall_s"],
        "compile_s": cold["wall_s"] - warm["wall_s"],
        "mrays_per_s": warm["mrays_per_s"],
        "ppm_repeat_identical": ppm_cold == ppm_warm,
    }
    say(f"{name}: {cfg['width']}x{cfg['height']} spp={spp} "
        f"depth={cfg['max_depth']} mode={cfg['mode']} "
        f"triangles={res['triangles']} build_s={res['build_s']} "
        f"native_sah={res['native_sah']} "
        f"compile_s={res['compile_s']:.2f} (cold {res['cold_s']:.2f} - "
        f"warm {res['run_s']:.2f}) run_s={res['run_s']:.3f} "
        f"rays={res['rays']} mrays_per_s={res['mrays_per_s']:.3f}")
    return res


def device_film(name: str):
    """(cfg, scene, cam, film, stats) of one preset at its smoke spp,
    through render.render — the function the CLI calls (its program is
    already compiled by the preset phase)."""
    from tpurt import config, render

    cfg = config.PRESETS[name].replace(spp=SMOKE_SPP[name])
    scene, cam = config.build_scene(cfg)
    film, stats = render.render(cfg, scene, cam)
    require(np.isfinite(film).all(), f"{name}: non-finite film")
    return cfg, scene, cam, film, stats


def phase_parity(name: str, cfg, scene, cam, film) -> dict:
    from tpurt import cpu_ref

    pix = parity_pixels(cfg.width, cfg.height)
    t0 = time.perf_counter()
    ref, _ = cpu_ref.render_pixels(cfg, scene, cam, pix)
    r = compare_films(film.reshape(-1, 3)[pix], ref)
    say(f"parity {name}: {PARITY_GRID[0]}x{PARITY_GRID[1]} pixels at "
        f"spp={cfg.spp}: {fmt(r)} oracle_s={time.perf_counter() - t0:.1f}")
    require(parity_ok(r), f"parity {name} outside tolerance: {r}")
    return r


def phase_denormals() -> None:
    import jax
    import jax.numpy as jnp

    from tpurt import config, cpu_ref, render

    prod = jax.jit(lambda a, b: a * b)(jnp.float32(1e-30),
                                       jnp.float32(1e-10))
    flushes = float(prod) == 0.0
    cfg = config.RenderConfig(width=48, height=36, spp=2, max_depth=4,
                              scene=f"obj:{VN_FIXTURE}", mode="mega",
                              seed=3, smooth=True)
    scene, cam = config.build_scene(cfg)
    f_dev, s_dev = render.render(cfg, scene, cam)
    f_ref, s_ref = cpu_ref.render(cfg, scene, cam)
    r = compare_films(f_dev, f_ref)
    say(f"denormals: 1e-30*1e-10 on the card = {float(prod):.3e} "
        f"(flushes f32 denormals: {flushes}); --smooth icosphere vs "
        f"oracle: rays {s_dev['rays']}/{s_ref['rays']} {fmt(r)}")
    require(parity_ok(r), f"smooth icosphere outside tolerance: {r}")


def single_card(out_dir: Path) -> None:
    res = {name: phase_preset(name, out_dir) for name in SMOKE_SPP}
    say("set-up (compile; fewer samples would not shorten it): "
        "compile_s " + " ".join(
            f"{n}={r['compile_s']:.1f}" for n, r in res.items())
        + f" (sum {sum(r['compile_s'] for r in res.values()):.1f})")

    # determinism: two more in-process c3 renders, linear films compared
    cfg, scene, cam, film_a, st_a = device_film("c3-mesh")
    *_, film_b, st_b = device_film("c3-mesh")
    same = film_a.tobytes() == film_b.tobytes()
    say(f"determinism c3-mesh: film bytes identical={same} rays "
        f"{st_a['rays']}/{st_b['rays']}; cli PPMs identical "
        f"c3={res['c3-mesh']['ppm_repeat_identical']} "
        f"c4={res['c4-wavefront']['ppm_repeat_identical']}")
    require(same and st_a["rays"] == st_b["rays"],
            "c3-mesh is not bit-reproducible on the card")
    require(res["c3-mesh"]["ppm_repeat_identical"]
            and res["c4-wavefront"]["ppm_repeat_identical"],
            "repeated CLI renders wrote different PPMs")

    say("precision: the render path has no matrix product, so TF32 does "
        "not apply and no matmul precision is set")
    phase_parity("c3-mesh", cfg, scene, cam, film_a)
    for name in ("c1-primary", "c2-cornell", "c4-wavefront"):
        phase_parity(name, *device_film(name)[:4])
    phase_denormals()


def spp_block(npix: int, cap: int) -> int:
    """Largest packet multiple (128 rays) that divides npix, up to cap."""
    for b in range(cap - cap % 128, 0, -128):
        if npix % b == 0:
            return b
    return cap


def four_card() -> None:
    import jax

    from tpurt import config, mesh as mesh_mod

    require(len(jax.devices()) >= 4,
            f"--four-card needs 4 cards, found {len(jax.devices())}")
    cfg = config.PRESETS["c5-multichip"].replace(spp=FOUR_CARD_SPP)
    # shard="spp" renders pixel blocks of ray_batch / cards pixels; a
    # block size that divides the frame spares a second program for a
    # ragged last block (ray_batch only regroups work: same image)
    cfg = cfg.replace(ray_batch=4 * spp_block(cfg.width * cfg.height,
                                              mesh_mod.SUB_BLOCK))
    t0 = time.perf_counter()
    scene, cam = config.build_scene(cfg)
    say(f"c5-multichip: {cfg.width}x{cfg.height} spp={cfg.spp} "
        f"depth={cfg.max_depth} ray_batch={cfg.ray_batch} "
        f"build_s={time.perf_counter() - t0:.2f}")
    runs = {
        "tiles/1": (cfg.replace(shard="tiles"), mesh_mod.make_mesh(1)),
        "tiles/4": (cfg.replace(shard="tiles"), mesh_mod.make_mesh(4)),
        "spp/4": (cfg.replace(shard="spp"), mesh_mod.make_mesh(4)),
    }

    def render(key):
        c, m = runs[key]
        t0 = time.perf_counter()
        film, rays = mesh_mod.render_samples_sharded(c, scene, cam, 0,
                                                     c.spp, mesh=m)
        require(np.isfinite(film).all(), f"c5 {key}: non-finite film")
        return film / c.spp, rays, time.perf_counter() - t0

    # Warm-up: each program compiles for minutes, so the three compile
    # (and then render) at once, one thread each. The timed renders
    # below run one at a time and compile nothing.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(runs)) as ex:
        warm = dict(zip(runs, ex.map(render, runs)))
    say(f"c5 warm-up: {len(runs)} programs compiled and rendered "
        f"concurrently in {time.perf_counter() - t0:.1f}s")
    timed = {key: render(key) for key in runs}
    for key, (film, rays, wall) in timed.items():
        same = film.tobytes() == warm[key][0].tobytes()
        say(f"c5 {key} (shard/cards): wall_s={wall:.3f} rays={rays} "
            f"mrays_per_s={rays / wall / 1e6:.3f} "
            f"repeat_identical={same}")
        require(same and rays == warm[key][1],
                f"c5 {key}: two renders in one process differ")
    (f1, r1, w1), (f4, r4, w4), (fs, rs, ws) = (
        timed["tiles/1"], timed["tiles/4"], timed["spp/4"])
    tiles = compare_films(f4, f1)
    spp = compare_films(fs, f1)
    say(f"c5 tiles 4 cards vs 1: {fmt(tiles)} rays {r4}/{r1}")
    say(f"c5 spp 4 cards vs tiles 1: {fmt(spp)} rays {rs}/{r1}")
    say(f"c5 scaling: 1 card {w1:.3f}s, 4 cards tiles {w4:.3f}s "
        f"(efficiency {w1 / (4 * w4):.3f}), spp {ws:.3f}s "
        f"(efficiency {w1 / (4 * ws):.3f})")
    require(tiles["byte_identical"] and r4 == r1,
            "shard=tiles on 4 cards differs from 1 card")
    require(spp["frac_px_over_level"] <= SPP_SHARD_FRAC
            and spp["rmse"] <= SPP_SHARD_RMSE,
            f"shard=spp outside tolerance: {spp}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-card", action="store_true",
                    help="run only the c5-multichip phase on 4 cards")
    ap.add_argument("--out-dir", default=str(REPO / "smoke_out"),
                    help="where the rendered PPMs go")
    args = ap.parse_args(argv)

    import jax

    from tpurt import compile_cache, gpu

    device = gpu.require_gpu(jax.devices())
    for ln in gpu.nvidia_smi():
        say(f"nvidia-smi: {ln}")
    say(f"jax {jax.__version__}: {device['count']} x {device['kind']}")
    say(f"compile cache: {compile_cache.enable()}")
    t0 = time.perf_counter()
    if args.four_card:
        require(device["count"] == 4, "--four-card expects exactly 4 cards")
        four_card()
    else:
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        single_card(out_dir)
    say(f"total_s={time.perf_counter() - t0:.1f}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
