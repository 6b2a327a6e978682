"""The device a measurement ran on.

Every speed number this project reports comes from a GPU run and names
its device. A measurement path calls ``require_gpu`` first: JAX falls back
to the CPU when the CUDA plugin fails to initialise, and a CPU time must
never be reported under a device metric's name.
"""

from __future__ import annotations

import subprocess


class NotAGPU(RuntimeError):
    pass


def require_gpu(devices=None) -> dict:
    """{"platform", "kind", "count"} of the devices as JAX reports them;
    raises NotAGPU unless the first one is a GPU."""
    if devices is None:
        import jax

        devices = jax.devices()
    d0 = devices[0]
    if d0.platform != "gpu":
        raise NotAGPU(f"platform is {d0.platform!r} ({d0.device_kind}), "
                      "not 'gpu': refusing to report a non-GPU run")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devices)}


def nvidia_smi(query: str = "name,power.limit") -> list[str]:
    """One line per card, as ``nvidia-smi --query-gpu=<query>
    --format=csv,noheader`` prints it."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
