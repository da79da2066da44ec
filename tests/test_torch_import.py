"""The PyTorch port stands alone: it imports neither JAX nor solr_tpu."""

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
        "solr_tpu_torch.frame_profile\n"
        "from solr_tpu_torch.bench_scene import bench_scene\n"
        "from solr_tpu_torch.ops.render import render_sample\n"
        "s, c, cfg = bench_scene(2000, block=128, width=32, height=32)\n"
        "img, _ = render_sample(s, c, cfg)\n"
        "assert img.shape == (32, 32, 4)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'solr_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    # Several test workers share the cores: keep the intra-op pool small.
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
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
