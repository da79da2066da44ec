"""The readers of the exactness net's strip lists, blocks per strip over
the window: they read the program's counters, and nothing on the other
mode, where the net never ran, or from a program whose net keeps no
strip lists (the parent of the one that added them)."""

import pytest

from solbench import manifest
from solbench.harness import LayerInputs

NAMES = ("net_strip_blocks", "net_strip_blocks.molecule")
NET = {"calls": 8, "needy_rays": 100, "strips": 5, "strip_blocks": 140,
       "windows": 6, "chunks": 6, "union_blocks": 140, "overflows": 0}


def _inputs(mode="frames", net=NET):
    return LayerInputs(mode, 2, 5, None, {"net": dict(net)}, 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_per_strip(name):
    assert manifest.reader(name).read(_inputs()) == pytest.approx(28.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    old = {k: v for k, v in NET.items()
           if k not in ("strips", "strip_blocks", "windows")}
    for inputs in (_inputs("grad"), _inputs(net=old), _inputs(net={}),
                   _inputs(net={**NET, "calls": 0, "strips": 0,
                                "strip_blocks": 0})):
        assert manifest.reader(name).read(inputs) is None
