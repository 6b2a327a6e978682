"""Command-line entry point (SURVEY.md §1 L11, §2 "CLI / main").

    python -m tpurt.cli render --preset c2-cornell --out cornell.ppm
    python -m tpurt.cli render --width 640 --height 480 --spp 16 \
        --scene spheres_plane --mode mega --out out.ppm
    python -m tpurt.cli render --preset c1-primary --oracle  # NumPy cpu_ref

Prints render stats (rays, seconds, Mrays/s — the reference's exit printout,
SURVEY.md §3.1) as one JSON object on stdout; --json-metrics also writes it
to a file for the benchmark harness (SURVEY.md §5 "Metrics").
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_parser(preset_names) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpurt")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a frame")
    r.add_argument("--preset", choices=preset_names, default=None)
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--max-depth", type=int, default=None)
    r.add_argument("--seed", type=int, default=None)
    r.add_argument("--scene", type=str, default=None,
                   help="spheres_plane | cornell | blob | obj:<path>")
    r.add_argument("--mode",
                   choices=["primary", "mega", "wavefront", "persist"],
                   default=None)
    r.add_argument("--rr-start", type=int, default=None)
    r.add_argument("--mesh-subdiv", type=int, default=None)
    r.add_argument("--smooth", action="store_true", default=None,
                   help="interpolate OBJ vn shading normals (A.5 optional "
                        "path; errors if the OBJ has no vn records)")
    r.add_argument("--aperture", type=float, default=None,
                   help="thin-lens diameter (world units; 0 = pinhole)")
    r.add_argument("--focus-dist", type=float, default=None,
                   help="in-focus plane distance (with --aperture)")
    r.add_argument("--shard", choices=["none", "tiles", "spp"], default=None)
    r.add_argument("--ray-batch", type=int, default=None)
    r.add_argument("--out", type=str, default=None,
                   help="output image path (.ppm, or .png via PIL)")
    r.add_argument("--oracle", action="store_true",
                   help="render with the NumPy cpu_ref instead of JAX")
    r.add_argument("--json-metrics", type=str, default=None)
    r.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file; pass with --resume to continue")
    r.add_argument("--checkpoint-every", type=int, default=64,
                   help="checkpoint every K samples")
    r.add_argument("--resume", action="store_true")
    r.add_argument("--profile-dir", type=str, default=None,
                   help="capture a jax.profiler (XProf) trace into this "
                        "directory; expect a large slowdown while tracing")
    return p


def main(argv=None) -> int:
    from . import config as config_mod

    parser = _build_parser(sorted(config_mod.PRESETS))
    args = parser.parse_args(argv)

    cfg = config_mod.PRESETS[args.preset] if args.preset else \
        config_mod.RenderConfig()
    overrides = {
        "width": args.width, "height": args.height, "spp": args.spp,
        "max_depth": args.max_depth, "seed": args.seed, "scene": args.scene,
        "mode": args.mode, "rr_start": args.rr_start,
        "mesh_subdiv": args.mesh_subdiv, "shard": args.shard,
        "ray_batch": args.ray_batch, "smooth": args.smooth,
        "aperture": args.aperture, "focus_dist": args.focus_dist,
    }
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})

    from . import metrics

    with metrics.Phase("scene_build") as ph:
        scene, cam = config_mod.build_scene(cfg)
    metrics.log_event("scene", build_s=round(ph.seconds, 3),
                      **metrics.scene_stats(scene))

    t0 = time.perf_counter()
    if args.oracle:
        from . import cpu_ref
        film, stats = cpu_ref.render(cfg, scene, cam)
        stats["wall_s"] = time.perf_counter() - t0
        stats["mrays_per_s"] = stats["rays"] / stats["wall_s"] / 1e6
        stats["backend"] = "cpu_ref"
    else:
        import jax

        from . import compile_cache
        compile_cache.enable()

        profile = None
        if args.profile_dir:
            jax.profiler.start_trace(args.profile_dir)
            profile = args.profile_dir

        if args.checkpoint:
            from . import checkpoint as ckpt_mod
            film, stats = ckpt_mod.render_with_checkpoints(
                cfg, scene, cam, args.checkpoint,
                every=args.checkpoint_every, resume=args.resume,
            )
        elif cfg.shard != "none":
            from . import mesh as mesh_mod
            film, stats = mesh_mod.render_sharded(cfg, scene, cam)
        else:
            from . import render as render_mod
            film, stats = render_mod.render(cfg, scene, cam)
        if profile:
            jax.profiler.stop_trace()
        stats["backend"] = jax.default_backend()
        stats["device_kind"] = jax.devices()[0].device_kind

    stats["config"] = {k: getattr(cfg, k) for k in
                       ("width", "height", "spp", "max_depth", "seed",
                        "scene", "mode", "rr_start", "shard")}

    if args.out:
        from . import film as film_mod
        from .io import ppm
        rgb8 = film_mod.tonemap(film)
        if args.out.lower().endswith(".png"):
            # same tonemapped bytes as the PPM path, PNG-encoded (PIL is
            # optional and imported only here; PPM stays the parity/golden
            # format)
            from PIL import Image
            Image.fromarray(rgb8).save(args.out)
        else:
            ppm.write(args.out, rgb8)
        stats["out"] = args.out

    print(json.dumps(stats))
    if args.json_metrics:
        with open(args.json_metrics, "w") as f:
            json.dump(stats, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
