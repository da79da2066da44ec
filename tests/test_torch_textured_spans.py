"""The spans of the textured frame and the readers of the textured cell's
per-layer metrics, on the CPU.

``solr/texture`` (``ops/textures.py``: ``sample_texture``,
``material_map_scales``, ``apply_normal_maps``) and ``solr/postfx``
(``ops/postfx.apply_postfx``) show under ``torch.profiler`` on a tiny
textured frame, which renders the same image as without the profiler;
a frame without textures or post-processing records neither; off the
profiler both are the shared no-op.  Each of the seven readers of
``textured_mixed.spp4`` returns its number on a hand-made trace, and
nothing without a trace, on a gradient run, or on a program that
records no such span, launches no walk or runs no kernel."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from solbench import manifest
from solbench.devtrace import DeviceTrace
from solbench.harness import LayerInputs
from solr_tpu_torch import Key, render
from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.textured_scene import textured_scene
from solr_tpu_torch.utils import profiling, render_phase

torch.set_num_threads(2)


def _spans(fn):
    """``fn()`` under the profiler: its result and its ``solr/`` spans
    (name, start_ns, end_ns) in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("solr/")), key=lambda x: x[1])
    return out, spans


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.fixture(scope="module")
def textured():
    return textured_scene(32, 18, bounces=2, ground_res=8, device="cpu")


def test_textured_frame_shows_texture_and_postfx_spans(textured):
    scene, cam, cfg = textured

    def frame():
        with torch.no_grad():
            return render(scene, cam, cfg, Key.seed(5, "cpu"), 2)

    plain = frame()
    img, spans = _spans(frame)
    assert torch.equal(img, plain)
    names = [s[0] for s in spans]
    frames = [s for s in spans if s[0] == "solr/frame"]
    assert len(frames) == 2  # one a sample
    postfx = [s for s in spans if s[0] == "solr/postfx"]
    assert len(postfx) == 1  # once, after the samples
    assert not any(_inside(postfx[0], f) for f in frames)
    textures = [s for s in spans if s[0] == "solr/texture"]
    assert textures and all(any(_inside(t, f) for f in frames)
                            for t in textures)
    # The maps of the shading, of the surface (normal and bump maps)
    # and of the continuation and the sky, in the bounce loop.
    for outer in ("solr/shade", "solr/surface"):
        assert any(_inside(t, s) for t in textures for s in spans
                   if s[0] == outer), outer
    assert any(not any(_inside(t, s) for s in spans
                       if s[0] in ("solr/shade", "solr/surface"))
               for t in textures)
    assert names.count("solr/shade") == 2 * cfg.max_bounces


def test_frames_without_maps_or_postfx_record_neither():
    scene, cam, cfg = bench_scene(2_000, block=64, width=32, height=32,
                                  bounces=2, device="cpu")
    with torch.no_grad():
        _, spans = _spans(lambda: render(scene, cam, cfg))
    names = {s[0] for s in spans}
    assert "solr/frame" in names and "solr/shade" in names
    assert "solr/texture" not in names and "solr/postfx" not in names


def test_spans_are_the_shared_no_op_off_the_profiler(textured):
    assert render_phase("texture") is render_phase("postfx") \
        is profiling._OFF
    scene, cam, cfg = textured
    with torch.no_grad():
        img, depth = render_sample(scene, cam, cfg)
    assert img.shape == (18, 32, 4) and depth.shape == (18, 32)


# --- the readers ----------------------------------------------------------

# Two profiled frames, times in microseconds.
HOST = [
    ("solr/frame", 0.0, 1000.0),
    ("solr/surface", 50.0, 150.0),
    ("solr/texture", 60.0, 100.0),
    ("solr/texture", 70.0, 90.0),  # nested in one of its own name
    ("solr/shade", 200.0, 500.0),
    ("solr/texture", 250.0, 300.0),
    ("solr/shade", 600.0, 700.0),
    ("solr/postfx", 1000.0, 1100.0),
    ("aten::mul", 210.0, 220.0),
]
ACTIVITY = [
    ("void closest_pairs<TriRow, true>(float4 const*)", 100.0, 160.0),
    ("void trans_pairs<TriRow>(float4 const*)", 300.0, 340.0),
    ("void at::native::elementwise_kernel", 400.0, 500.0),
    ("Memcpy DtoH (Device -> Pinned)", 700.0, 800.0),
]
WALK = {"bvh_closest_hit_tri": 24, "bvh_transmittance_tri": 96,
        "bvh_closest_hit_sphere": 0}
READERS = ("texture_ms.textured", "postfx_ms.textured", "shade_ms.textured",
           "walk_ms.textured", "walk_launches_per_frame.textured",
           "kernels_per_frame.textured", "device_idle_pct.textured")
VALUES = {
    # [60, 100] and [250, 300] -> 90 us over 2 frames
    "texture_ms.textured": 0.045,
    "postfx_ms.textured": 0.05,
    # [200, 500] and [600, 700] -> 400 us over 2 frames
    "shade_ms.textured": 0.2,
    # closest_pairs 60 + trans_pairs 40 us over 2 frames
    "walk_ms.textured": 0.05,
    # 120 launches over 4 window frames
    "walk_launches_per_frame.textured": 30.0,
    "kernels_per_frame.textured": 1.5,
    # busy 60 + 40 + 100 + 100 us of a 1,100-us span
    "device_idle_pct.textured": 100.0 * (1.0 - 300.0 / 1100.0),
}


def _inputs(mode="frames", trace=True, host=HOST, activity=ACTIVITY,
            walk=WALK):
    kernels = [a for a in activity if not a[0].startswith("Memcpy")]
    tr = DeviceTrace(kernels, activity, host, 1100e-6) if trace else None
    return LayerInputs(mode, 2, 4, tr, {"walk": dict(walk)}, 1.0)


def read(name, inputs):
    return manifest.reader(name).read(inputs)


def test_the_cell_lists_exactly_these_readers():
    cell = manifest.Cell("textured_mixed.spp4")
    assert {m["name"] for m in cell.per_layer} == set(READERS) == set(VALUES)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_number(name):
    assert read(name, _inputs()) == pytest.approx(VALUES[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_trace_or_on_a_step(name):
    counted = name == "walk_launches_per_frame.textured"
    assert (read(name, _inputs(trace=False)) is None) != counted
    assert read(name, _inputs(mode="grad")) is None


@pytest.mark.parametrize("name,inputs", [
    # A program without the texture and postfx spans (the parent of the
    # program that added them): the shading span is still read.
    ("texture_ms.textured", _inputs(host=[h for h in HOST
                                          if h[0] != "solr/texture"])),
    ("postfx_ms.textured", _inputs(host=[h for h in HOST
                                         if h[0] != "solr/postfx"])),
    ("shade_ms.textured", _inputs(host=[h for h in HOST
                                        if h[0] != "solr/shade"])),
    ("texture_ms.textured", _inputs(host=[h for h in HOST
                                          if not h[0].startswith("solr/")])),
    # No walk kernel ran, and none was launched.
    ("walk_ms.textured", _inputs(activity=ACTIVITY[2:])),
    ("walk_launches_per_frame.textured", _inputs(walk={})),
    ("walk_launches_per_frame.textured", _inputs(walk=dict.fromkeys(WALK,
                                                                    0))),
    # No kernel, no device activity.
    ("kernels_per_frame.textured", _inputs(activity=[])),
    ("device_idle_pct.textured", _inputs(activity=[])),
])
def test_reader_reads_nothing_where_there_is_nothing(name, inputs):
    assert read(name, inputs) is None


def test_shade_is_read_without_the_new_spans():
    host = [h for h in HOST if h[0] not in ("solr/texture", "solr/postfx")]
    assert read("shade_ms.textured", _inputs(host=host)) == pytest.approx(
        VALUES["shade_ms.textured"])
