#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA device(s) the
cell asks for; the last line of standard output is the result (see
`portbench/bench.py`). The program's kernel library and every compiler
cache live under the checkout's ``build/``, so only a checkout's first run
builds.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
os.environ["MMPFN_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from portbench.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
