"""What the GPU bring-up relies on, checked on the CPU: the compile-cache
location, chip_smoke.py's device refusal and parity comparator, and the
absence of code that only a TPU can run. The ``gpu``-marked test renders
the goldens on the card and skips elsewhere."""

from __future__ import annotations

import pathlib
import re
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("env", [None, "/cache/from/env"])
def test_compile_cache_dir(env, monkeypatch):
    import jax

    from tpurt import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.append((name, value)))
    if env is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = str(REPO / ".jax_cache")
        assert compile_cache.enable() == want
        assert updates == [("jax_compilation_cache_dir", want)]
        # fixed, gitignored and inside the checkout
        assert ".jax_cache/" in (REPO / ".gitignore").read_text()
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
        assert compile_cache.enable() == env
        assert updates == []   # JAX reads the variable itself


def test_smoke_refuses_cpu_before_rendering(tmp_path, capsys):
    from tpurt import gpu

    out_dir = tmp_path / "smoke"
    with pytest.raises(gpu.NotAGPU, match="not 'gpu'"):
        chip_smoke.main(["--out-dir", str(out_dir)])
    assert not out_dir.exists()
    assert '"ok"' not in capsys.readouterr().out


def test_require_gpu_accepts_gpu_devices():
    from tpurt import gpu

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    assert gpu.require_gpu([Dev()] * 4) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


@pytest.mark.parametrize("perturb,ok", [
    (lambda f: f, True),
    (lambda f: f * 1.25, False),                 # brightness shift
    (lambda f: f * 1.002, False),                # shift within one level
    (lambda f: f[:, :, ::-1], False),            # colour channels swapped
    (lambda f: np.where(np.arange(f.shape[1])[None, :, None] < 48,
                        f, 0.0), False),         # half the frame lost
])
def test_parity_comparator(perturb, ok):
    rs = np.random.default_rng(5)
    ref = rs.uniform(0.05, 0.9, (54, 96, 3)).astype(np.float32)
    r = chip_smoke.compare_films(perturb(ref.copy()), ref)
    assert chip_smoke.parity_ok(r) is ok, r
    if ok:
        assert r["byte_identical"] and r["rmse"] == 0.0


def test_parity_comparator_tolerates_isolated_flips():
    """A few whole-pixel outliers (flipped paths) stay inside tolerance."""
    rs = np.random.default_rng(6)
    ref = rs.uniform(0.05, 0.9, (54, 96, 3)).astype(np.float32)
    dev = ref.copy()
    dev[10, 20] = 0.0
    dev[30, 70] = 1.0
    r = chip_smoke.compare_films(dev, ref)
    assert chip_smoke.parity_ok(r), r
    assert 0 < r["frac_px_over_level"] <= chip_smoke.PARITY_FRAC
    assert r["rmse_inlier_rel"] == 0.0


def test_parity_pixels_cover_the_frame():
    pix = chip_smoke.parity_pixels(1280, 720)
    assert pix.shape == (96 * 54,) and len(np.unique(pix)) == pix.size
    assert pix.min() == 0 and pix.max() == 1280 * 720 - 1


@pytest.mark.parametrize("name", ["loop", "brute", "node", "leaf"])
def test_plain_kernel_bench_steps(name):
    """The timing loop of benchmarks/bench_plain_kernels.py calls the step
    on unchanged inputs: k calls in one loop give the single jitted
    call's outputs. Small frame, small mesh, two packets."""
    import jax

    sys.path.insert(0, str(REPO / "benchmarks"))
    import bench_plain_kernels as bpk

    info, step, feed, args = getattr(bpk, f"bench_{name}")(
        256, width=64, height=32, mesh_subdiv=3)
    once = jax.tree.map(np.asarray, jax.jit(step)(*args))
    for k in (1, 3):
        got = jax.tree.map(np.asarray, bpk.looped(step, feed, k)(*args))
        assert jax.tree.structure(got) == jax.tree.structure(once)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(once)):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    r = bpk.per_call_ms(step, feed, args, reps=1)
    assert r["reps"] == 1 and np.isfinite(r["median_ms"])
    assert info


_TPU_ONLY = re.compile(
    r"pallas\s*\.\s*tpu|pallas import tpu|pl[t]pu|lib[t]pu"
    r"|default_backend\(\)\s*[=!]=\s*[\"']tpu[\"']")


@pytest.mark.parametrize("root", ["tpurt", "tests", "benchmarks", "."])
def test_no_tpu_only_code(root):
    paths = ([REPO / "bench.py", REPO / "chip_smoke.py",
              REPO / "__graft_entry__.py"] if root == "."
             else sorted((REPO / root).rglob("*.py")))
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in paths if p.name != "test_bringup.py"
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _TPU_ONLY.search(line)]
    assert hits == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["g1-primary", "g3-cornell", "g5-rr"])
def test_golden_on_gpu(name, gpu_device):
    """The card renders each golden within the CPU test's byte tolerance
    (tests/test_golden.py::test_device_matches_golden). The BVH goldens
    are left to chip_smoke.py's c3/c4 parity: their programs take minutes
    to compile on the GPU."""
    import jax

    from golden_defs import GOLDENS
    from tpurt import config, film, render
    from tpurt.io import ppm

    cfg = GOLDENS[name]
    with jax.default_device(gpu_device):
        scene, cam = config.build_scene(cfg)
        img, _ = render.render(cfg, scene, cam)
    golden = ppm.read(str(REPO / "tests" / "golden" / f"{name}.ppm"))
    diff = np.abs(film.tonemap(img).astype(int) - golden.astype(int))
    assert (diff > 1).mean() < 0.002
    assert diff.max() <= 8
