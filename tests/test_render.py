"""Render-loop structure properties (SURVEY.md §1 L9).

The counter-derived RNG contract ((seed, pixel, sample) streams) makes
the image invariant to every perf-only regrouping the render loop is
allowed to make: pixel-block size, sample-chunk size, ragged tail
chunks, and sample-span composition (the checkpoint/resume unit). These
tests pin that invariance on the plain frame loop.

History: this file used to pin the bit-exactness of two regrouping
engines (cross-batch tail coalescing and sample-major packets) that lost
on the previous accelerator and were deleted; they live at commit
69c49fb if ever needed again.
"""

import numpy as np
import pytest

from tpurt import config, render

CFG = config.RenderConfig(width=64, height=32, spp=4, scene="blob",
                          mesh_subdiv=2, mode="mega", max_depth=6,
                          seed=5, ray_batch=1024)
# 2048 px / 1024-block => 2 blocks x 4 sample-chunks = 8 iterations


@pytest.fixture(scope="module")
def blob_scene():
    scene, cam = config.build_scene(CFG)
    return scene.device(), cam


@pytest.fixture(scope="module")
def plain_frame(blob_scene):
    scene, cam = blob_scene
    f0, n0 = render.render_samples(CFG, scene, cam, 0, CFG.spp)
    return np.asarray(f0), n0


@pytest.mark.parametrize("ray_batch", [512, 2048])
def test_batch_grouping_invisible(blob_scene, plain_frame, ray_batch):
    """Different pixel-block sizes regroup which rays share a dispatch
    (512: 4 blocks x 1-sample chunks; 2048: whole frame per block,
    1-sample chunks) — the film and ray count must be bit-identical."""
    scene, cam = blob_scene
    f0, n0 = plain_frame
    cfg = CFG.replace(ray_batch=ray_batch)
    f1, n1 = render.render_samples(cfg, scene, cam, 0, cfg.spp)
    assert n1 == n0
    assert np.array_equal(np.asarray(f1), f0)


def test_ragged_sample_chunk(blob_scene, plain_frame):
    """spp_chunk=3 over 4 samples exercises the ragged-tail dispatch
    (one c=3 chunk + one c=1 chunk, separate compiles) bit-exactly."""
    scene, cam = blob_scene
    f0, n0 = plain_frame
    cfg = CFG.replace(spp_chunk=3)
    f1, n1 = render.render_samples(cfg, scene, cam, 0, cfg.spp)
    assert n1 == n0
    assert np.array_equal(np.asarray(f1), f0)


def test_sample_span_composition(blob_scene, plain_frame):
    """The checkpoint/resume contract: two sample spans accumulated into
    one film equal the one-call render bit-exactly."""
    scene, cam = blob_scene
    f0, n0 = plain_frame
    f1, n1a = render.render_samples(CFG, scene, cam, 0, 2)
    f1, n1b = render.render_samples(CFG, scene, cam, 2, CFG.spp, f1)
    assert n1a + n1b == n0
    assert np.array_equal(np.asarray(f1), f0)


def test_wavefront_spans_compose(blob_scene):
    """Span composition through the wavefront chunk loop
    (_wavefront_frame): a 3-sample span (ragged c=3) plus a 1-sample
    span accumulate to the one-call film bit-exactly."""
    scene, cam = blob_scene
    cfg = CFG.replace(mode="wavefront", rr_start=3)
    f0, n0 = render.render_samples(cfg, scene, cam, 0, cfg.spp)
    f1, n1a = render.render_samples(cfg, scene, cam, 0, 3)
    f1, n1b = render.render_samples(cfg, scene, cam, 3, cfg.spp, f1)
    assert n1a + n1b == n0
    assert np.array_equal(np.asarray(f1), np.asarray(f0))
