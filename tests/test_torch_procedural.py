"""``ops/textures.procedural_color`` and its kernels
(``csrc/procedural.cu``) on the CPU.

The device rule: CPU tensors take ``procedural_color_plain`` (the
reference's seven kinds for every ray, selected) with and without grad,
and launch nothing; a tensor on another device raises.  A plain mirror
of the backward kernel's per-kind formulas (tests/torch_procedural_helpers)
agrees with ``torch.autograd`` through the plain version in float64:
exactly for NONE, MANDELBROT, JULIA and CHECKER, and within 1e-12 of each
kind's largest entry for NOISE, MARBLE and GRANITE, whose chain rule it
takes in another association.  The kernels, emulated on the CPU
(tests/torch_sweep_helpers.py), hold to the same: the forward bit for
bit, and the backward exactly, for the kinds without a sine in float32
and in float64, and within 1e-9 for the rest in float64.  The emulation
calls the host's libm sine, which differs from PyTorch's CPU sine in the
last bit of a few inputs; the value-noise hash multiplies that by 43,758
and takes the fraction, so a float32 hash can come out wholly different,
and a float64 one moves by about 1e-11.  The card's own runs, where both
call the same sine, are tests/test_torch_gpu.py."""

import pytest
import torch

from solr_tpu_torch.ops import textures as tex
from torch_procedural_helpers import (CASES, KINDS,
                                      assert_grads_match, autograd_grads,
                                      inputs, procedural_bwd_plain)
from torch_sweep_helpers import build_emulated, compiler

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

N = 1000  # not a multiple of the kernels' 256-thread blocks


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_takes_the_plain_version(grad):
    kind, scale, uv, base, g = inputs("mixed", 300)
    before = dict(tex.LAUNCHES)
    want = tex.procedural_color_plain(kind, scale, uv, base)
    if grad:
        uv = uv.clone().requires_grad_()
    out = tex.procedural_color(kind, scale, uv, base)
    assert torch.equal(out, want)
    if grad:
        out.backward(g)
        assert uv.grad is not None
    assert tex.LAUNCHES == before


def test_other_devices_raise():
    """The device rule, with grad and without: a tensor on neither the
    CPU nor a CUDA card raises, and reaches no kernel."""
    before = dict(tex.LAUNCHES)
    kind, scale, uv, base, _ = (x.to("meta") for x in inputs("0", 8))
    with pytest.raises(ValueError, match="no procedural_color kernel"):
        tex.procedural_color(kind, scale, uv, base)
    with pytest.raises(ValueError, match="no procedural_color kernel"):
        tex.procedural_color(kind, scale, uv.requires_grad_(), base)
    assert tex.LAUNCHES == before


def test_kernels_refuse_what_they_do_not_take():
    kind, scale, uv, base, g = inputs("0", 8)
    with pytest.raises(ValueError, match="int32 kinds and float32"):
        tex.launch(None, kind.long(), scale, uv, base)
    with pytest.raises(ValueError, match="int32 kinds and float32"):
        tex.launch(None, kind, scale.half(), uv.half(), base.half())
    with pytest.raises(ValueError, match="of one shape"):
        tex.launch(None, kind, scale[:4], uv, base)
    with pytest.raises(ValueError, match="gradient of the output's shape"):
        tex.launch_bwd(None, kind, scale, uv, base, g[:, :3])


@pytest.mark.parametrize("case", CASES)
def test_backward_mirror_matches_autograd(case):
    """The backward kernel's formulas, mirrored in PyTorch, against
    autograd through procedural_color_plain in float64."""
    args = inputs(case, 600, torch.float64)
    assert_grads_match(procedural_bwd_plain(*args), autograd_grads(*args),
                       args[0], 1e-12)


# --------------------------------------------------------------------------
# The kernels, emulated
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a C++17 compiler to build the emulation")
    return tex.load_library(build_emulated(
        tex.LIBRARY.src, tmp_path_factory.mktemp("emu")))


# float32 takes the kinds without a sine alone (see the module's note).
EMULATED = ([("f32", c) for c in ("0", "1", "2", "3", "mixed")]
            + [("f64", c) for c in CASES])
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _own_rows(kind, dtype):
    """The rays the emulation is held to bit for bit: all in float64,
    those of the kinds without a sine in float32."""
    k = kind.long().clamp(0, KINDS - 1)
    return (torch.ones_like(k, dtype=torch.bool) if dtype == torch.float64
            else (k <= 3))


@pytest.mark.parametrize("dtype,case", EMULATED)
def test_emulated_forward_matches_plain(emulated, dtype, case):
    kind, scale, uv, base, _ = inputs(case, N, DTYPES[dtype])
    got = tex.launch(emulated, kind, scale, uv, base)
    want = tex.procedural_color_plain(kind, scale, uv, base)
    exact = kind.long().clamp(0, KINDS - 1) <= 3
    assert torch.equal(got[exact].view(torch.uint8),
                       want[exact].view(torch.uint8))
    rest = _own_rows(kind, DTYPES[dtype]) & ~exact
    if rest.any():
        assert float((got[rest] - want[rest]).abs().max()) <= 1e-9
        assert torch.equal(got[rest][:, 3], want[rest][:, 3])


@pytest.mark.parametrize("dtype,case", EMULATED)
def test_emulated_backward_matches_autograd(emulated, dtype, case):
    """The backward kernel against autograd through the plain version:
    exactly for the kinds without a sine, within 1e-9 of each kind's
    largest entry for the rest (float64); and each output left out of
    ``need`` is None while the others are unchanged."""
    args = inputs(case, N, DTYPES[dtype])
    rows = _own_rows(args[0], DTYPES[dtype])
    got = tex.launch_bwd(emulated, *args)
    want = autograd_grads(*args)
    assert_grads_match([g[rows] for g in got], [w[rows] for w in want],
                       args[0][rows], 1e-9)
    part = tex.launch_bwd(emulated, *args, need=(False, True, False))
    assert part[0] is None and part[2] is None
    assert torch.equal(part[1], got[1])


def test_emulated_kernels_take_no_rays(emulated):
    kind, scale, uv, base, g = inputs("mixed", 0)
    assert tex.launch(emulated, kind, scale, uv, base).shape == (0, 4)
    assert [x.shape for x in tex.launch_bwd(emulated, kind, scale, uv, base,
                                            g)] == [(0, 2), (0,), (0, 4)]
