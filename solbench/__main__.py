"""``python -m solbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.

The kernel caches stay in fixed directories of the checkout: the
program builds its nvcc and g++ libraries under ``build/solr_tpu_torch/``
itself; Triton's, PyTorch's extension and CUDA's JIT caches are set to
``build/solbench/`` here, before CUDA starts."""

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (to about 10 ms,
    from /proc), else now."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "solbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")

if __name__ == "__main__":
    try:
        from solbench.harness import main
    except ImportError as err:
        print(f"cannot import the benchmark or the program: {err!r}",
              file=sys.stderr)
        sys.exit(5)
    sys.exit(main(sys.argv[1:], T_START))
