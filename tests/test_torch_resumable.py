"""Resumable row-band rendering in the port (``solr_tpu_torch.utils.
resumable``): the counterparts of tests/test_fault_injection.py's
resume cases, and ROADMAP C5, which the port fixes.

An interruption here is in-process: the ``log`` callback raises after a
number of chunks, which leaves the checkpoints an interrupted worker
would.  (The kill-one-host harness, tools/fault_injection.py, is not
ported yet; chip_smoke.py's ``resumable`` phase kills a rank on the
card.)  C5 and C15 are shown both ways: the reference resumes a stale
directory and returns a wrong frame, the port discards it and renders
the right one.
"""

import os

import jax
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops.render import render_sample as j_render_sample
from solr_tpu.utils.resumable import resumable_render as j_resumable_render

from solr_tpu_torch import Camera, Key, PlaneAxis, SceneBuilder
from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.utils.checkpoint import latest_step
from solr_tpu_torch.utils.resumable import (heartbeat_age, resumable_render,
                                            touch_heartbeat)

torch.set_num_threads(2)


class Interrupted(Exception):
    pass


def stop_after(n_chunks, events=None):
    """A ``log`` callback that records events and raises after
    ``n_chunks`` chunks are done (and checkpointed)."""
    done = []

    def log(event, **fields):
        if events is not None:
            events.append((event, fields))
        if event == "chunk_done":
            done.append(fields["chunk"])
            if len(done) == n_chunks:
                raise Interrupted
    return log


def _tiny(ref, position=(0.0, 0.5, -3.0), angles=(0.0, 0.0, 0.0)):
    """tests/test_fault_injection.py's scene, built by the reference
    (``ref``) or the port."""
    b = st.SceneBuilder() if ref else SceneBuilder()
    m = b.add_material(color=(0.8, 0.3, 0.3, 1.0))
    b.add_plane(st.types.PlaneAxis.XZ if ref else PlaneAxis.XZ,
                (0.0, -1.0, 0.0), (8.0, 8.0), m)
    b.add_sphere((0.0, 0.0, 2.0), 0.8, m)
    b.add_light((0.0, 5.0, -1.0))
    if ref:
        return b.build(), st.Camera.create(position=position, angles=angles,
                                           fov=1.0)
    return (b.build(device="cpu"),
            Camera.create(position=position, angles=angles, fov=1.0,
                          device="cpu"))


CFG = st.RenderConfig(width=32, height=32, max_bounces=2)


@pytest.fixture(scope="module")
def tiny():
    from solr_tpu_torch import RenderConfig

    scene, cam = _tiny(False)
    return scene, cam, RenderConfig(width=32, height=32, max_bounces=2)


def test_resume_is_bit_identical(tiny, tmp_path):
    scene, cam, cfg = tiny
    full, full_depth = resumable_render(scene, cam, cfg, str(tmp_path / "a"),
                                        rows_per_chunk=8)
    events = []
    part = str(tmp_path / "b")
    with pytest.raises(Interrupted):
        resumable_render(scene, cam, cfg, part, rows_per_chunk=8,
                         log=stop_after(2, events))
    assert latest_step(part) == 2
    img, depth = resumable_render(scene, cam, cfg, part, rows_per_chunk=8,
                                  log=stop_after(99, events))
    assert ("resumed", {"from_chunk": 2}) in events
    assert [f["chunk"] for e, f in events if e == "chunk_done"] == [0, 1, 2, 3]
    assert latest_step(part) == 4
    np.testing.assert_array_equal(img.numpy(), full.numpy())
    np.testing.assert_array_equal(depth.numpy(), full_depth.numpy())


@pytest.mark.parametrize("case", ["tiny", "bench"])
def test_matches_one_shot_render(tiny, tmp_path, case):
    """Chunked rendering equals the one-shot frame bit for bit; the
    bench frame's 16-row chunks are whole 16x16 packet tiles."""
    if case == "tiny":
        scene, cam, cfg = tiny
        rows = 16
    else:
        scene, cam, cfg = bench_scene(2000, block=128, width=32, height=32,
                                      device="cpu")
        rows = 16
    want, want_depth = render_sample(scene, cam, cfg)
    img, depth = resumable_render(scene, cam, cfg, str(tmp_path),
                                  rows_per_chunk=rows, cleanup=True)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    np.testing.assert_array_equal(depth.numpy(), want_depth.numpy())
    assert not os.path.exists(tmp_path)


def _interrupt_then_resume(render, scene, cam, cfg, directory, rows_after,
                           rows_before=8, cam_after=None, drop_fp=False,
                           chunks=2, key=None, key_after=None):
    """Interrupt a render (with ``key``) after ``chunks`` chunks of
    ``rows_before`` rows, then run the same directory again with
    ``rows_after`` rows per chunk (and ``cam_after``, ``key_after``);
    returns (frame, events of the second run)."""
    with pytest.raises(Interrupted):
        render(scene, cam, cfg, directory, rows_per_chunk=rows_before,
               key=key, log=stop_after(chunks))
    if drop_fp:
        os.unlink(os.path.join(directory, "fingerprint"))
    events = []
    img, _ = render(scene, cam if cam_after is None else cam_after, cfg,
                    directory, rows_per_chunk=rows_after, key=key_after,
                    log=stop_after(99, events))
    return np.asarray(img), [e for e, _ in events]


def test_c5_changed_rows_per_chunk_is_stale(tiny, tmp_path):
    """ROADMAP C5: a directory of 8-row chunks run again with 16-row
    chunks.  The reference's fingerprint leaves the chunk height out, so
    it resumes at chunk 2 of 2 and returns rows 16-31 unrendered; the
    port's is stale and starts over."""
    j_scene, j_cam = _tiny(True)
    want = np.asarray(jax.jit(j_render_sample, static_argnums=2)(
        j_scene, j_cam, CFG)[0])
    got, events = _interrupt_then_resume(j_resumable_render, j_scene, j_cam,
                                         CFG, str(tmp_path / "ref"), 16)
    assert "resumed" in events and "stale_checkpoint_discarded" not in events
    assert np.abs(got[16:] - want[16:]).max() > 0.1  # the fault

    scene, cam, cfg = tiny
    want = render_sample(scene, cam, cfg)[0].numpy()
    got, events = _interrupt_then_resume(resumable_render, scene, cam, cfg,
                                         str(tmp_path / "port"), 16)
    assert events[0] == "stale_checkpoint_discarded"
    assert "resumed" not in events
    np.testing.assert_array_equal(got, want)


def test_c5_checkpoints_without_fingerprint_are_stale(tiny, tmp_path):
    """ROADMAP C5: an interrupted directory loses its fingerprint file
    and is run again for another camera.  The reference resumes its
    chunks (rows 0-15 of the old view); the port starts over."""
    moved = dict(position=(0.3, 0.8, -3.0))
    j_scene, j_cam = _tiny(True)
    _, j_moved = _tiny(True, **moved)
    want = np.asarray(jax.jit(j_render_sample, static_argnums=2)(
        j_scene, j_moved, CFG)[0])
    got, events = _interrupt_then_resume(
        j_resumable_render, j_scene, j_cam, CFG, str(tmp_path / "ref"), 8,
        cam_after=j_moved, drop_fp=True)
    assert "resumed" in events
    assert np.abs(got[:16] - want[:16]).max() > 0.1  # the old view's rows

    scene, cam, cfg = tiny
    _, moved_cam = _tiny(False, **moved)
    want = render_sample(scene, moved_cam, cfg)[0].numpy()
    got, events = _interrupt_then_resume(
        resumable_render, scene, cam, cfg, str(tmp_path / "port"), 8,
        cam_after=moved_cam, drop_fp=True)
    assert events[0] == "stale_checkpoint_discarded"
    np.testing.assert_array_equal(got, want)


def test_c15_another_key_is_stale(tmp_path):
    """ROADMAP C15: a 16x16 frame with soft shadows (4 samples, a view
    where both 8-row chunks hold penumbra), interrupted after its first
    chunk with key A and run again with key B.  The reference's
    fingerprint leaves the key out: it resumes, and its frame is A's
    first chunk beside B's second.  The port's is stale: it starts over
    and returns B's frame.  A band draws its own soft-shadow samples in
    both packages, so B's frame is an uninterrupted chunked run with
    B."""
    view = dict(angles=(0.4, 0.0, 0.0))

    def frames(render, scene, cam, cfg, key_a, key_b, name):
        whole = [np.asarray(render(scene, cam, cfg,
                                   str(tmp_path / f"{name}{i}"),
                                   rows_per_chunk=8, key=k)[0])
                 for i, k in enumerate((key_a, key_b))]
        got, events = _interrupt_then_resume(
            render, scene, cam, cfg, str(tmp_path / name), 8, chunks=1,
            key=key_a, key_after=key_b)
        return whole, got, events

    j_scene, j_cam = _tiny(True, **view)
    jcfg = st.RenderConfig(width=16, height=16, max_bounces=2,
                           shadow_samples=4)
    (a, b), got, events = frames(j_resumable_render, j_scene, j_cam, jcfg,
                                 jax.random.PRNGKey(1), jax.random.PRNGKey(2),
                                 "ref")
    assert "resumed" in events and "stale_checkpoint_discarded" not in events
    np.testing.assert_array_equal(got[:8], a[:8])  # the fault: A's rows
    np.testing.assert_array_equal(got[8:], b[8:])
    assert np.abs(got[:8] - b[:8]).max() > 1e-3

    from solr_tpu_torch import RenderConfig

    scene, cam = _tiny(False, **view)
    cfg = RenderConfig(width=16, height=16, max_bounces=2, shadow_samples=4)
    (a, b), got, events = frames(resumable_render, scene, cam, cfg,
                                 Key.seed(1, "cpu"), Key.seed(2, "cpu"),
                                 "port")
    assert np.abs(a[:8] - b[:8]).max() > 1e-3
    assert events[0] == "stale_checkpoint_discarded"
    assert "resumed" not in events
    np.testing.assert_array_equal(got, b)


@pytest.mark.parametrize("key", [7, "0xF00D"], ids=["int", "str"])
def test_key_of_another_type_raises(tiny, tmp_path, key):
    """A key that is neither a Key nor None cannot be fingerprinted, so
    resumable_render refuses it before rendering (ROADMAP C15)."""
    scene, cam, cfg = tiny
    with pytest.raises(TypeError, match=type(key).__name__):
        resumable_render(scene, cam, cfg, str(tmp_path), rows_per_chunk=16,
                         key=key)
    assert not os.path.exists(tmp_path / "fingerprint")


def test_fresh_directory_is_not_stale(tiny, tmp_path):
    """An empty or new directory renders without a discard event."""
    scene, cam, cfg = tiny
    events = []
    resumable_render(scene, cam, cfg, str(tmp_path / "new"),
                     rows_per_chunk=16, log=stop_after(99, events))
    assert [e for e, _ in events] == ["chunk_done", "chunk_done"]


def test_heartbeat(tmp_path):
    path = str(tmp_path / "beat")
    assert heartbeat_age(path) is None
    touch_heartbeat(path)
    assert 0.0 <= heartbeat_age(path) < 60.0
