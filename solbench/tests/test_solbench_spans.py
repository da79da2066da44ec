"""The readers of the program's spans and split counters on a hand-made
trace: nested spans of one name count once, spans inside the net do not
change its time, the device's busy time comes off the net's idle time,
and only syncs under a span count.  Each reader returns nothing
on a cell of the other mode, without a trace, and on a program that
records no spans or does not split its counters."""

import pytest

from solbench import manifest
from solbench.devtrace import DeviceTrace
from solbench.harness import LayerInputs

# Two profiled frames, times in microseconds.
FRAMES_HOST = [
    ("solr/frame", 0.0, 1000.0),
    ("solr/closest", 10.0, 400.0),
    ("solr/net", 100.0, 300.0),
    ("solr/net", 120.0, 180.0),  # nested in a net of its own name
    ("solr/brute", 150.0, 200.0),  # the net's overflow brute
    ("solr/closest", 450.0, 600.0),
    ("solr/brute", 500.0, 550.0),  # a small pool's brute, outside the net
    ("solr/shadow", 650.0, 900.0),
    ("solr/net", 700.0, 800.0),
    ("aten::mul", 105.0, 140.0),
    ("cudaMemcpyAsync", 130.0, 131.0),
    ("cudaStreamSynchronize", 110.0, 111.0),
    ("cudaStreamSynchronize", 160.0, 161.0),
    ("cudaEventSynchronize", 720.0, 721.0),
    ("cudaDeviceSynchronize", 1100.0, 1101.0),  # after the frame
]
FRAMES_ACTIVITY = [
    ("void kernel_a", 100.0, 150.0),
    ("void kernel_b", 250.0, 400.0),
    ("Memcpy DtoH (Device -> Pinned)", 700.0, 720.0),
    ("void kernel_c", 950.0, 990.0),
]
GRAD_HOST = [
    ("solr/refresh", 0.0, 40.0),
    ("solr/frame", 50.0, 900.0),
    ("solr/walk", 60.0, 100.0),
    ("cudaStreamSynchronize", 70.0, 71.0),
    ("solr/refresh", 2000.0, 2060.0),
    ("cudaStreamSynchronize", 2010.0, 2011.0),
    ("cudaStreamSynchronize", 2950.0, 2951.0),  # the loss read, no span
    ("solr/frame", 2100.0, 2900.0),
]
NET = {"calls": 8, "needy_rays": 100, "chunks": 4, "union_blocks": 40,
       "overflows": 1, "needy_primary_closest": 10,
       "needy_primary_shadow": 50, "needy_later_closest": 15,
       "needy_later_shadow": 25}


def _trace(host, activity):
    kernels = [a for a in activity if not a[0].startswith("Memcpy")]
    return DeviceTrace(kernels, activity, host, 0.003)


def frames(trace=True, host=FRAMES_HOST, net=NET):
    return LayerInputs("frames", 2, 5,
                       _trace(host, FRAMES_ACTIVITY) if trace else None,
                       {"net": dict(net)}, 1.0)


def grad(trace=True, host=GRAD_HOST):
    return LayerInputs("grad", 2, 7,
                       _trace(host, []) if trace else None, {"net": {}},
                       1.0)


def read(name, inputs):
    return manifest.reader(name).read(inputs)


FRAME_VALUES = {
    # net union: [100, 300] and [700, 800] -> 300 us over 2 frames
    "net_ms": 0.15, "net_ms.molecule": 0.15,
    # the net less the kernels and copies inside it: 300 - (50 + 50 + 20)
    "net_idle_ms.molecule": 0.09,
    # (50 + 25) needy shadow rays over 5 window frames
    "net_needy_shadow_rays": 15.0, "net_needy_shadow_rays.molecule": 15.0,
    # three syncs start under a span, one after the frame
    "host_syncs_per_frame": 1.5, "host_syncs_per_frame.molecule": 1.5,
}
GRAD_VALUES = {
    # refresh: 40 + 60 us over 2 steps
    "refresh_ms.grad": 0.05,
    # the walk's sync and the second refresh's; the loss read has no span
    "host_syncs_per_step.grad": 1.0,
}


@pytest.mark.parametrize("name", sorted(FRAME_VALUES))
def test_frame_readers(name):
    assert read(name, frames()) == pytest.approx(FRAME_VALUES[name],
                                                 rel=1e-12)
    assert read(name, grad()) is None


@pytest.mark.parametrize("name", sorted(GRAD_VALUES))
def test_grad_readers(name):
    assert read(name, grad()) == pytest.approx(GRAD_VALUES[name], rel=1e-12)
    assert read(name, frames()) is None


@pytest.mark.parametrize("name", sorted(FRAME_VALUES) + sorted(GRAD_VALUES))
def test_nothing_to_read(name):
    """No trace, or a program without spans or split counters (the parent
    of the program that added them) reads nothing and does not raise."""
    old_net = {k: v for k, v in NET.items() if not k.startswith("needy_")}
    for inputs in (frames(trace=False, net=old_net), grad(trace=False),
                   frames(host=[h for h in FRAMES_HOST
                                if not h[0].startswith("solr/")],
                          net=old_net),
                   grad(host=[h for h in GRAD_HOST
                              if not h[0].startswith("solr/")])):
        assert read(name, inputs) is None


def test_needy_shadow_rays_need_a_net_call():
    for name in ("net_needy_shadow_rays", "net_needy_shadow_rays.molecule"):
        assert read(name, frames(net={**NET, "calls": 0})) is None


def test_net_ms_does_not_depend_on_the_spans_inside_the_net():
    host = [h for h in FRAMES_HOST if h != ("solr/brute", 150.0, 200.0)]
    assert read("net_ms", frames(host=host)) == pytest.approx(0.15)


def test_every_new_reader_has_its_values():
    names = {m["name"] for m in manifest.benchmark()["per_layer"]
             if m["source"] in ("program_span", "program_counter")}
    assert set(FRAME_VALUES) | set(GRAD_VALUES) <= names
