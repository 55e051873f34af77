"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <traffic>.<config> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for. Prints information lines, then one JSON result line last on
standard output; the numbers `correct` compares, each beside its limit,
are the last lines on standard error. Exits non-zero, with no result line,
without the card, without the port, or if JAX or the JAX package was
loaded.

The port's build directory (its nvcc-built kernels and native library),
Triton's cache, PyTorch's extension directory and the compiled bytecode of
every Python module the run imports (`sys.pycache_prefix`) are fixed
directories under .portbench_cache/ in the checkout, so only a checkout's
first run builds and compiles.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["BLAZE_TPU_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # torch's modules are compiled from source at every import where the
    # installation holds no bytecode; keep what this checkout compiled
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_process=T_PROCESS,
                       t_imported=time.perf_counter())


if __name__ == "__main__":
    sys.exit(main())
