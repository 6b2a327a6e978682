"""tpurt — a wavefront path tracer in JAX, run on NVIDIA GPUs.

A JAX/XLA framework with the capabilities of
``ACEfanatic02/par_raytracer`` (a multithreaded tile-parallel CPU path
tracer). The reference tree was unreadable at build time (see SURVEY.md §0),
so behavior follows the normative algorithm spec in SURVEY.md Appendix A,
reconstructed from the driver's BASELINE.json contract.

Layer map (SURVEY.md §1):
  linalg   — vec3 math over (..., 3) jnp arrays          (ref L1)
  rng      — counter-based threefry per-pixel streams    (ref L2)
  geometry — branchless sphere/plane/triangle hit tests  (ref L3)
  bvh      — host NumPy builder -> flattened node arrays (ref L4)
  materials— branchless diffuse/metal/dielectric scatter (ref L5)
  trace    — megakernel bounce loop (lax.while_loop)     (ref L6)
  wavefront— SoA ray-queue mode with compaction + RR     (ref L6')
  camera   — thin-lens ray-gen with AA jitter            (ref L7)
  scene    — SoA scene pytree + built-in scenes          (ref L8)
  render   — render loop; mesh.py shards it over cards   (ref L9/L0)
  film     — accumulation, tonemap                       (ref L10)
  io.ppm   — binary P6 writer                            (ref L10)
  cli      — entry point + the 5 BASELINE presets        (ref L11)
  cpu_ref  — NumPy oracle renderer (RMSE parity)         (new, L12)
"""

__version__ = "0.1.0"
