"""Native (C++) host library, bound with ctypes (counterpart of
solr_tpu/native).

Two host-side hot loops in C++, this package's own copies of the
reference's sources:

* ``src/lbvh.cc``: the Morton-ordered median-split LBVH build behind
  ``solr_tpu_torch.ops.bvh.build_bvh`` (``build_bvh_plain`` is its
  plain version, in numpy, with the same node arrays), and the
  per-triangle AABBs;
* ``src/objparse.cc``: the Wavefront OBJ geometry parser behind
  ``solr_tpu_torch.io.obj.load_obj`` (``parse_obj`` is its plain
  version).

The library is compiled with ``g++ -O3 -march=native`` at first use,
never at import, into ``build/solr_tpu_torch/``, under a name keyed by
the sources, the flags and the compiler and CPU (what ``-march=native``
resolves to), so a library built for one CPU is never loaded on
another.  Nothing falls back: a failed build or load raises with the
compiler's message.

``cached_build`` is the build cache, and ``Library`` the handle built
and loaded at first use, of every native library of the port: this one,
and the CUDA kernels that ``ops.cudalib`` builds with nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["Library", "load_library", "lbvh_build", "triangle_aabbs",
           "obj_load", "cached_build", "compile_library", "BUILD_DIR",
           "CXX_FLAGS", "SOURCES"]

_SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = (_SRC_DIR / "lbvh.cc", _SRC_DIR / "objparse.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "solr_tpu_torch"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
# The names buffer of the first obj_parse call; a file whose material
# names need more is parsed again with a buffer of its own size.
_NAMES_BYTES = 1 << 20


def _compiler_fingerprint() -> str:
    """The compiler's version, the machine, and the target options that
    ``-march=native`` turns on for this CPU."""
    def run(*args):
        res = subprocess.run(["g++", *args], capture_output=True, text=True,
                             timeout=60)
        if res.returncode != 0:
            raise RuntimeError(f"g++ {' '.join(args)} failed:\n{res.stderr}")
        return res.stdout

    return "|".join([platform.machine(), run("--version").splitlines()[0],
                     run("-march=native", "-Q", "--help=target"),
                     *CXX_FLAGS])


def cached_build(stem: str, key: bytes, command, sources=(),
                 build_dir=BUILD_DIR, timeout=None):
    """Build ``build_dir/{stem}_{hash of key}.so`` unless it is there.
    Returns (its path, the compiler's output, or '' when it was there).

    ``command(out, srcs)`` gives the compiler's argv that writes the
    library to ``out``; ``sources`` are (suffix, bytes) pairs, written
    beside it for that call as the files ``srcs``.  The library is
    written under a temporary name and renamed into place, so several
    processes or threads may build at once.  Raises RuntimeError with
    the compiler's output when it fails."""
    out = Path(build_dir) / f"{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    srcs = [tmp.parent / f"{tmp.name}{i}{suffix}"
            for i, (suffix, _) in enumerate(sources)]
    try:
        for path, (_, text) in zip(srcs, sources):
            path.write_bytes(text)
        argv = command(tmp, srcs)
        res = subprocess.run(argv, capture_output=True, text=True,
                             timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"{Path(argv[0]).name} failed "
                               f"({res.returncode}):\n{res.stdout}\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        for path in (tmp, *srcs):
            path.unlink(missing_ok=True)
    return out, res.stdout + res.stderr


def compile_library(sources=SOURCES, build_dir=BUILD_DIR) -> Path:
    """Compile ``sources`` with g++ into
    ``build_dir/libsolr_native_{hash}.so`` unless it is there, and
    return its path.  Raises RuntimeError with g++'s output when the
    build fails."""
    key = b"".join(Path(src).read_bytes() for src in sources)
    return cached_build(
        "libsolr_native", key + _compiler_fingerprint().encode(),
        lambda out, _: ["g++", *CXX_FLAGS, *map(str, sources), "-o",
                        str(out)],
        build_dir=build_dir, timeout=300)[0]


class Library:
    """A native library, built and loaded at first use, once a process:
    ``compile(verbose)`` returns (its path, the compiler's output or
    ''), ``load(path)`` loads it and declares its entry points; ``src``
    is the path of its one source, where it has one.  A failed build or
    load raises."""

    def __init__(self, compile, load, src=None):
        self._compile, self._load, self.src = compile, load, src
        self._lib = None
        self._lock = threading.Lock()

    def build(self, verbose: bool = False) -> str:
        """Build the library unless it is there, and load it.  Returns
        the compiler's output when it built, '' when the library was
        already there."""
        with self._lock:
            path, log = self._compile(verbose)
            if self._lib is None:
                self._lib = self._load(path)
            return log

    def load(self):
        """The loaded library, built first if need be."""
        if self._lib is None:
            self.build()
        return self._lib


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.solr_lbvh_build.restype = i64
    lib.solr_lbvh_build.argtypes = [vp, vp, i64, i32, vp, vp, vp, vp, vp, vp,
                                    vp, i64]
    lib.solr_triangle_aabbs.restype = None
    lib.solr_triangle_aabbs.argtypes = [vp, vp, vp, i64, vp, vp]
    lib.obj_count.restype = ctypes.c_int
    lib.obj_count.argtypes = [ctypes.c_char_p, vp]
    lib.obj_parse.restype = ctypes.c_int
    lib.obj_parse.argtypes = [ctypes.c_char_p, vp, vp, vp, vp, vp, vp, vp,
                              ctypes.c_char_p, ctypes.c_longlong, vp]
    return lib


_LIBRARY = Library(lambda verbose: (compile_library(), ""),
                   lambda path: _declare(ctypes.CDLL(str(path))))


def load_library():
    """Build (once per source, flag and compiler set) and load the
    library.  Raises on any failure."""
    return _LIBRARY.load()


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def lbvh_build(aabb_min, aabb_max, leaf_size: int):
    """The LBVH over primitives with AABBs (N, 3): (order, starts, ends,
    skips, depths, nmin, nmax), the intermediates that
    ``solr_tpu_torch.ops.bvh.build_bvh_plain`` computes in numpy."""
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    n = amin.shape[0]
    if amin.shape != (n, 3) or amax.shape != (n, 3) or n == 0 \
            or leaf_size <= 0:
        raise ValueError(f"lbvh_build takes two (N, 3) arrays, N > 0, and a "
                         f"positive leaf size; got {amin.shape}, "
                         f"{amax.shape}, {leaf_size}")
    lib = load_library()
    # Median splits halve ranges exactly, so leaves number at most
    # 2 * ceil(n / leaf_size) and nodes at most twice that.
    cap = 4 * ((n + leaf_size - 1) // leaf_size) + 8
    order = np.empty(n, np.int32)
    starts, ends, skips, depths = (np.empty(cap, np.int32) for _ in range(4))
    nmin, nmax = np.empty((cap, 3), np.float32), np.empty((cap, 3), np.float32)
    k = lib.solr_lbvh_build(_ptr(amin), _ptr(amax), n, leaf_size,
                            _ptr(order), _ptr(starts), _ptr(ends),
                            _ptr(skips), _ptr(depths), _ptr(nmin), _ptr(nmax),
                            cap)
    if k <= 0:
        raise RuntimeError(f"solr_lbvh_build returned {k}")
    return (order, starts[:k], ends[:k], skips[:k], depths[:k], nmin[:k],
            nmax[:k])


def triangle_aabbs(v0, v1, v2):
    """Per-triangle AABBs (min, max), each (N, 3) float32, of vertex
    arrays (N, 3)."""
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    n = v0.shape[0]
    if any(v.shape != (n, 3) for v in (v0, v1, v2)):
        raise ValueError(f"triangle_aabbs takes three (N, 3) arrays; got "
                         f"{v0.shape}, {v1.shape}, {v2.shape}")
    lib = load_library()
    out_min, out_max = (np.empty((n, 3), np.float32) for _ in range(2))
    lib.solr_triangle_aabbs(_ptr(v0), _ptr(v1), _ptr(v2), n, _ptr(out_min),
                            _ptr(out_max))
    return out_min, out_max


def obj_load(path: str) -> dict:
    """The geometry of an OBJ file, with ``parse_obj``'s contract
    (solr_tpu_torch.io.obj): ``v`` (nv, 3), ``vt`` (nvt, 2) and ``vn``
    (nvn, 3) float32; per triangle ``f_v``, ``f_vt``, ``f_vn`` (ntris,
    3) int32, 0-based, -1 where absent, and ``f_slot`` (ntris,) int32
    (-1 before any usemtl); ``mtllibs`` and the slot-ordered
    ``usemtls``.  Raises OSError when the file cannot be read and
    RuntimeError when it changed between the parser's two passes."""
    lib = load_library()
    raw = os.fsencode(path)
    counts = np.zeros(4, np.int64)
    if lib.obj_count(raw, _ptr(counts)):
        raise OSError(f"cannot read {path}")
    nv, nvt, nvn, nf = (int(x) for x in counts)
    v = np.empty((nv, 3), np.float32)
    vt = np.empty((max(nvt, 1), 2), np.float32)
    vn = np.empty((max(nvn, 1), 3), np.float32)
    f_v, f_vt, f_vn = (np.empty((nf, 3), np.int32) for _ in range(3))
    f_slot = np.empty(nf, np.int32)
    for size in (_NAMES_BYTES, os.path.getsize(path) + 2):
        names = ctypes.create_string_buffer(size)
        # The first pass's counts cap every write of the second: a file
        # that changed between them gives rc 3, not a heap overrun.
        rc = lib.obj_parse(raw, _ptr(v), _ptr(vt), _ptr(vn), _ptr(f_v),
                           _ptr(f_vt), _ptr(f_vn), _ptr(f_slot), names,
                           len(names), _ptr(counts))
        if rc != 2:  # 2: the names did not fit
            break
    if rc == 1:
        raise OSError(f"cannot read {path}")
    if rc:
        raise RuntimeError(f"obj_parse of {path} failed ({rc}): the file "
                           "changed while it was read")
    mtl, _, use = names.value.decode(errors="replace").partition("\x01")
    return {"v": v, "vt": vt[:nvt], "vn": vn[:nvn], "f_v": f_v, "f_vt": f_vt,
            "f_vn": f_vn, "f_slot": f_slot,
            "mtllibs": [m for m in mtl.split("\n") if m],
            "usemtls": [m for m in use.split("\n") if m]}
