"""``ops/gather.gather_rows``: the forward is ``table[idx]``; with grad
mode on and a table that requires grad its backward is
``gather_rows_bwd``, which on the CPU equals ``index_add_`` into zeros
bit for bit, and off those it builds no autograd node.  The kernel
``csrc/gather.cu``, emulated on the CPU (tests/torch_sweep_helpers.py),
sums the same rows: bit for bit where every order of the sum is exact
(small integers, and in float64 small integers with a 2^-30 part that
float32 would drop), and within float32 rounding of a float64 sum on
random rows, whose order its atomics change.  Both of its paths run:
tables of up to ``solr_gather_shared_bytes()`` bytes summed in shared
memory, larger ones straight into the output.  The card's own runs are
tests/test_torch_gpu.py."""

import math

import pytest
import torch

from solr_tpu_torch.ops import gather
from torch_sweep_helpers import build_emulated, compiler

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

ROW_SHAPES = {"1d": (), "n3": (3,)}


def _case(name, n, row, gen):
    """(table, idx) of one index pattern over an ``n``-row table."""
    table = torch.randn((n,) + row, generator=gen)
    if name == "one_index":
        idx = torch.full((5000,), 3, dtype=torch.int64)
    elif name == "every_row":
        idx = torch.randperm(n, generator=gen)
    elif name == "empty":
        idx = torch.zeros(0, dtype=torch.int64)
    else:  # "mixed": most rows on a few indices, the rest spread
        idx = torch.randint(0, 4, (3000,), generator=gen)
        idx[::5] = torch.randint(0, n, idx[::5].shape, generator=gen)
    return table, idx


def _grad_in(shape, gen, zero_share=0.5):
    """Random incoming rows, about ``zero_share`` of them exact zeros
    (half of those -0.0), as torch.where leaves a gather's don't-care
    rows."""
    g = torch.randn(shape, generator=gen)
    rows = g.view(shape[0], math.prod(shape[1:]))
    pick = torch.rand(shape[0], generator=gen)
    rows[pick < zero_share] = 0.0
    rows[pick < zero_share / 2] = -0.0
    return g


@pytest.mark.parametrize("case", ["one_index", "zero_rows", "empty",
                                  "every_row", "mixed"])
@pytest.mark.parametrize("row", ROW_SHAPES)
def test_backward_is_index_add(case, row):
    gen = torch.Generator().manual_seed(11)
    table, idx = _case("mixed" if case == "zero_rows" else case, 257,
                       ROW_SHAPES[row], gen)
    leaf = table.clone().requires_grad_()
    out = gather.gather_rows(leaf, idx)
    assert out.grad_fn is not None
    assert torch.equal(out, table[idx])
    g = (torch.zeros(out.shape) if case == "zero_rows"
         else _grad_in(out.shape, gen))
    out.backward(g)
    want = torch.zeros(table.shape).index_add_(0, idx, g)
    assert torch.equal(leaf.grad, want)
    assert torch.equal(leaf.grad.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("row", ROW_SHAPES)
def test_backward_of_nd_indices(row):
    """Indices of any shape, as the walks' leaf lanes gather them."""
    gen = torch.Generator().manual_seed(12)
    table = torch.randn((40,) + ROW_SHAPES[row], generator=gen)
    idx = torch.randint(0, 40, (30, 4), generator=gen)
    leaf = table.clone().requires_grad_()
    out = gather.gather_rows(leaf, idx)
    g = torch.randn(out.shape, generator=gen)
    out.backward(g)
    want = torch.zeros(table.shape).index_add_(
        0, idx.reshape(-1), g.reshape((-1,) + ROW_SHAPES[row]))
    assert torch.equal(leaf.grad, want)


@pytest.mark.parametrize("mode", ["no_grad", "no_requires_grad"])
def test_plain_gather_builds_no_node(mode):
    table = torch.randn(10, 3)
    idx = torch.tensor([0, 3, 3, 9])
    if mode == "no_grad":
        table.requires_grad_()
        with torch.no_grad():
            out = gather.gather_rows(table, idx)
    else:
        out = gather.gather_rows(table, idx)
    assert out.grad_fn is None
    assert torch.equal(out, table.detach()[idx])


def test_gradient_flows_through_the_scene_gathers():
    """A leaf table gathered by the pool helper of the traversal takes
    the Function (its node in the graph), and its gradient is the
    index_add_ of the incoming rows."""
    from solr_tpu_torch.constants import POOL_SPHERE
    from solr_tpu_torch.scene import SceneBuilder
    from solr_tpu_torch.ops import traverse

    b = SceneBuilder()
    m = b.add_material(color=(0.8, 0.2, 0.2, 1.0))
    for k in range(3):
        b.add_sphere((float(k), 0.0, 4.0), 0.4, m)
    scene = b.build(device="cpu")
    center = scene.spheres.center.clone().requires_grad_()
    scene = scene.replace(spheres=scene.spheres.replace(center=center))
    n = center.shape[0]  # the pool, padded
    idx = torch.tensor([0, 2, 2, n + 5, -1], dtype=torch.int32)
    (rows,) = traverse._hit_rows(scene, POOL_SPHERE, idx, "center")
    assert type(rows.grad_fn).__name__ == "_GatherRowsBackward"
    g = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    rows.backward(g)
    want = torch.zeros(n, 3).index_add_(0, idx.clamp(0, n - 1).long(), g)
    assert torch.equal(center.grad, want)


def test_kernel_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="float32 or float64 rows of 1-4"):
        gather.launch(None, torch.zeros(4, 5),
                      torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="float32 or float64 rows of 1-4"):
        gather.launch(None, torch.zeros(4, 2, dtype=torch.float16),
                      torch.zeros(4, dtype=torch.int64), 8)


# --------------------------------------------------------------------------
# The kernel, emulated
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a C++17 compiler to build the emulation")
    return gather.load_library(build_emulated(
        gather._SRC, tmp_path_factory.mktemp("emu")))


def _exact_grad(shape, gen, dtype=torch.float32):
    """Small integers, -0.0 and 0.0 (in float64 each integer with a
    multiple of 2^-30 that float32 would round away): every order of
    their sums is exact."""
    g = torch.randint(-8, 9, shape, generator=gen).to(dtype)
    if dtype == torch.float64:
        g += torch.randint(-8, 9, shape, generator=gen) * 2.0 ** -30
    rows = g.view(shape[0], math.prod(shape[1:]))
    rows[torch.rand(shape[0], generator=gen) < 0.3] = -0.0
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("table", ["shared", "global"])
def test_emulated_kernel_sums_exactly(emulated, table, width, dtype):
    """Both paths, every width, both value types: the rows of one index
    summed once each (a lost or doubled row shows), zero rows dropped,
    on a pattern with runs of one index, indices spread over the table
    and rows past the last whole warp; more rows than the shared path's
    CTAs take in one pass, so its threads loop."""
    gen = torch.Generator().manual_seed(width)
    size = torch.empty(0, dtype=dtype).element_size()
    limit = emulated.solr_gather_shared_bytes() // size
    n = 24 if table == "shared" else limit // width + 7
    rows = 2 * 2 * 256 + 45  # two SMs x kCtasPerSm CTAs of 256 threads
    idx = torch.randint(0, 3, (rows,), generator=gen)
    idx[100:200] = 1
    idx[::3] = torch.randint(0, n, idx[::3].shape, generator=gen)
    shape = (rows,) if width == 1 else (rows, width)
    g = _exact_grad(shape, gen, dtype)
    got = gather.launch(emulated, g, idx, n)
    want = gather.gather_rows_bwd_plain(g, idx, n)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", ["one_index", "mixed", "every_row"])
def test_emulated_kernel_against_float64(emulated, case):
    """Random rows: the kernel's sums within float32 rounding of a
    float64 index_add_.  Its tree and its atomics add in another order
    than the rows come, so the bound is the one of any order: a sum of
    k terms rounds by at most (k - 1) 2^-24 times the sum of their
    magnitudes."""
    gen = torch.Generator().manual_seed(5)
    table, idx = _case(case, 600, (3,), gen)
    idx = idx[:1100]
    g = _grad_in((idx.shape[0], 3), gen)
    got = gather.launch(emulated, g, idx, table.shape[0])
    want = torch.zeros(table.shape, dtype=torch.float64).index_add_(
        0, idx, g.double())
    scale = torch.zeros(table.shape, dtype=torch.float64).index_add_(
        0, idx, g.double().abs())
    bound = scale * (idx.numel() - 1) * 2.0 ** -24
    assert (got.double() - want).abs().le(bound).all()


def test_emulated_kernel_keeps_nan_and_drops_out_of_range(emulated):
    """A NaN row is not a zero row, so its sum is NaN; an index outside
    [0, n) adds nothing (the plain version raises there)."""
    g = torch.ones(64, 2)
    g[5, 1] = float("nan")
    idx = torch.tensor([1] * 32 + [2] * 30 + [-1, 9])
    got = gather.launch(emulated, g, idx, 4)
    assert torch.isnan(got[1, 1]) and got[1, 0] == 32.0
    assert torch.equal(got[2], torch.full((2,), 30.0))
    assert torch.equal(got[[0, 3]], torch.zeros(2, 2))
