"""The PyTorch port and chip_smoke.py stand alone: they import neither
JAX nor solr_tpu."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "solr_tpu_torch")


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['solr_tpu'] = None\n"
        "import solr_tpu_torch, solr_tpu_torch.convert, "
        "solr_tpu_torch.bench_scene, solr_tpu_torch.ops.sweep, "
        "solr_tpu_torch.frame_profile, solr_tpu_torch.molecule_scene, "
        "solr_tpu_torch.io.pdb, solr_tpu_torch.kernel_shapes, "
        "solr_tpu_torch.sweep_steps, solr_tpu_torch.walk_steps, "
        "solr_tpu_torch.ops.bvh, solr_tpu_torch.ops.pools, "
        "solr_tpu_torch.ops.cudalib, "
        "solr_tpu_torch.cornell_scene, solr_tpu_torch.utils, "
        "solr_tpu_torch.inverse, solr_tpu_torch.textured_scene, "
        "solr_tpu_torch.ops.postfx, solr_tpu_torch.ops.rng, "
        "solr_tpu_torch.parallel, solr_tpu_torch.parallel.launch, "
        "solr_tpu_torch.utils.logging, solr_tpu_torch.utils.resumable, "
        "solr_tpu_torch.utils.profiling, solr_tpu_torch.engine, "
        "solr_tpu_torch.scenes, solr_tpu_torch.io, solr_tpu_torch.viewer, "
        "solr_tpu_torch.oracle, solr_tpu_torch.native, "
        "solr_tpu_torch.fault_injection, solr_tpu_torch.bench_scaling, "
        "solr_tpu_torch.bench, solr_tpu_torch.utils.card, chip_smoke\n"
        "from solr_tpu_torch.viewer import main\n"
        "import tempfile, os\n"
        "out = os.path.join(tempfile.mkdtemp(), 'k.png')\n"
        "main(['--scene', 'knot', '--device', 'cpu', '--width', '16',\n"
        "      '--height', '16', '--out', out])\n"
        "assert os.path.getsize(out) > 0\n"
        "from solr_tpu_torch.bench_scene import bench_scene\n"
        "from solr_tpu_torch.ops.render import render_sample\n"
        "s, c, cfg = bench_scene(2000, block=128, width=32, height=32,\n"
        "                         device='cpu')\n"
        "img, _ = render_sample(s, c, cfg)\n"
        "assert img.shape == (32, 32, 4)\n"
        "from solr_tpu_torch import Key, render\n"
        "from solr_tpu_torch.textured_scene import textured_scene\n"
        "s, c, cfg = textured_scene(24, 16, ground_res=8, device='cpu')\n"
        "assert render(s, c, cfg, Key.seed(0, 'cpu'), spp=2).shape == "
        "(16, 24, 4)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'solr_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    # Several test workers share the cores: keep the intra-op pool small.
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_no_jax_or_reference_imports_in_source():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    bad = []
    for path in paths:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "solr_tpu"):
                    bad.append(f"{path}: {m}")
    assert not bad, bad


def _ops_imports(name):
    """(the port's modules that ops/{name}.py imports, the private names
    it takes from them)."""
    tree = ast.parse(open(os.path.join(PKG, "ops", name + ".py")).read())
    mods, private, aliases = set(), [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("solr_tpu_torch"):
            for a in node.names:
                if node.module in ("solr_tpu_torch", "solr_tpu_torch.ops"):
                    mods.add(f"{node.module}.{a.name}")
                    aliases.add(a.asname or a.name)
                else:
                    mods.add(node.module)
                    if a.name.startswith("_"):
                        private.append(f"{node.module}.{a.name}")
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in aliases and node.attr.startswith("_") and \
                not node.attr.startswith("__"):
            private.append(f"{node.value.id}.{node.attr}")
    return mods, private


def test_ops_import_arrows_point_one_way():
    """Within ops/: the primitive math and the sweep kernels import
    nothing of the packet layer, which only traversal and rendering
    import; the walks and the gathers import nothing of the sweep
    module; and no module takes another's private name."""
    names = [f[:-3] for f in os.listdir(os.path.join(PKG, "ops"))
             if f.endswith(".py")]
    imports = {n: _ops_imports(n) for n in names}
    packet = "solr_tpu_torch.ops.packet"
    assert sorted(n for n in names if packet in imports[n][0]) == \
        ["render", "traverse"]
    for n in ("bvh", "gather"):
        assert "solr_tpu_torch.ops.sweep" not in imports[n][0], n
    assert not [p for n in names for p in imports[n][1]]


def test_parallel_helpers_import_no_jax():
    """Spawned ranks import tests/torch_parallel_helpers.py, also on the
    card's host, which has no JAX: its module-level imports take none
    (the keyed scenario imports JAX inside a rank)."""
    path = os.path.join(ROOT, "tests", "torch_parallel_helpers.py")
    tree = ast.parse(open(path).read(), path)
    mods = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "solr_tpu", "torch_rng_helpers")], mods


def test_bench_reads_no_environment():
    """The port's bench takes its settings from flags alone: it reads no
    environment variable, unlike bench.py."""
    path = os.path.join(PKG, "bench.py")
    tree = ast.parse(open(path).read(), path)
    reads = [ast.unparse(node) for node in ast.walk(tree)
             if isinstance(node, ast.Attribute)
             and node.attr in ("environ", "getenv", "environb")]
    assert not reads, reads
