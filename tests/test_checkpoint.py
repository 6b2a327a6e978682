"""Checkpoint/resume exactness (SURVEY.md §5): a resumed render is
bit-identical to an uninterrupted run *with the same chunk boundaries*
(counter-based RNG makes the samples identical; float summation order is
fixed by the chunking). Across different chunkings the images agree to
summation noise."""

import numpy as np
import pytest

from tpurt import checkpoint, config, film as film_mod, render

CFG = config.RenderConfig(width=32, height=24, spp=12, max_depth=5,
                          scene="spheres_plane", mode="mega", seed=2,
                          spp_chunk=5)


@pytest.fixture(scope="module")
def sp():
    scene, cam = config.build_scene(CFG)
    return scene.device(), cam


def test_checkpointed_equals_plain(sp, tmp_path):
    scene, cam = sp
    # every=5 == spp_chunk=5 -> identical accumulation order -> bit equality
    f_plain, s_plain = render.render(CFG, scene, cam)
    f_ck, s_ck = checkpoint.render_with_checkpoints(
        CFG, scene, cam, str(tmp_path / "a.npz"), every=5
    )
    assert s_ck["checkpoints_written"] == 2  # after spp 5 and 10
    assert s_ck["rays"] == s_plain["rays"]
    assert np.array_equal(f_plain, f_ck)


def test_checkpointing_chunk_invariant(sp, tmp_path):
    scene, cam = sp
    f_plain, _ = render.render(CFG.replace(spp_chunk=0), scene, cam)
    f_ck, _ = checkpoint.render_with_checkpoints(
        CFG, scene, cam, str(tmp_path / "b.npz"), every=7
    )
    assert film_mod.rmse(f_plain, f_ck) < 1e-6


def test_resume_is_exact(sp, tmp_path):
    scene, cam = sp
    path = str(tmp_path / "c.npz")
    # simulate a crash after the first checkpoint block (8 of 12 samples)
    import jax.numpy as jnp
    film = jnp.zeros((CFG.width * CFG.height, 3), jnp.float32)
    film, rays = render.render_samples(CFG, scene, cam, 0, 8, film)
    checkpoint.save(path, CFG, np.asarray(film), 8, int(rays))

    # resume the job
    f_res, s_res = checkpoint.render_with_checkpoints(
        CFG, scene, cam, path, every=8, resume=True
    )
    assert s_res["resumed_from_spp"] == 8

    # uninterrupted run with the same checkpoint cadence: bit-identical
    f_full, s_full = checkpoint.render_with_checkpoints(
        CFG, scene, cam, str(tmp_path / "d.npz"), every=8
    )
    assert np.array_equal(f_full, f_res)
    assert s_full["rays"] == s_res["rays"]


def test_sharded_checkpoint_resume_exact(sp, tmp_path):
    """Checkpointing composes with tile sharding:
    interrupt a fake-mesh sharded render after K spp, resume, and the image
    is bit-identical to the uninterrupted sharded run with the same chunk
    cadence."""
    from tpurt import mesh as mesh_mod

    scene, cam = config.build_scene(CFG)   # un-placed; mesh device_puts it
    cfg = CFG.replace(shard="tiles")
    mesh = mesh_mod.make_mesh(8)
    path = str(tmp_path / "s.npz")

    # simulate a crash after the first 8 of 12 samples (sharded chunk)
    film, rays = mesh_mod.render_samples_sharded(cfg, scene, cam, 0, 8,
                                                 mesh=mesh)
    checkpoint.save(path, cfg, film, 8, int(rays))

    f_res, s_res = checkpoint.render_with_checkpoints(
        cfg, scene, cam, path, every=8, resume=True, mesh=mesh
    )
    assert s_res["resumed_from_spp"] == 8
    assert s_res["devices"] == 8

    f_full, s_full = checkpoint.render_with_checkpoints(
        cfg, scene, cam, str(tmp_path / "s2.npz"), every=8, mesh=mesh
    )
    assert np.array_equal(f_full, f_res)
    assert s_full["rays"] == s_res["rays"]

    # and the sharded checkpointed image agrees with the plain render
    f_plain, s_plain = render.render(CFG, *sp)
    assert film_mod.rmse(f_plain, f_res) < 1e-6
    assert s_plain["rays"] == s_res["rays"]


def test_resume_rejects_config_mismatch(sp, tmp_path):
    scene, cam = sp
    path = str(tmp_path / "e.npz")
    checkpoint.save(path, CFG, np.zeros((CFG.width * CFG.height, 3),
                                        np.float32), 4, 100)
    with pytest.raises(ValueError, match="different config"):
        checkpoint.load(path, CFG.replace(seed=99))
