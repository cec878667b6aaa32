"""Run one cell of ``BENCHMARK.json`` once, on the card, and print one line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, then ``setup_parts`` (the seconds of
each part of the set-up: imports, context, inputs, each warm-up query),
``checked`` and, last, ``checks``: each compared number beside its limit,
which also end standard error.

It exits 2, printing no result, without a card (or with fewer than the
cell asks for), and 3 if a module of JAX or of the JAX package is loaded
once the window has closed, in this process or in any rank's. A cell of
several ranks (`ranks.py`) in which a rank failed prints its result,
``correct`` false, and exits 4. Build and kernel caches are kept at fixed
paths inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# The checkout, not this directory, is where imports start.
sys.path[0] = str(CHECKOUT)

from benchmark.clock import SetupClock  # noqa: E402

CACHES = {
    "TRITON_CACHE_DIR": "build/cache/triton",
    "TORCH_EXTENSIONS_DIR": "build/cache/torch_extensions",
    "CUDA_CACHE_PATH": "build/cache/cuda",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)
    setup = SetupClock(T_START)
    import torch

    setup.lap("import_torch")
    from benchmark import harness

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    setup.lap("import_benchmark")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    setup.lap("find_card")
    from benchmark import program

    setup.lap("import_program")
    package = Path(program.package_file()).resolve()
    if CHECKOUT not in package.parents:
        print(f"run.py: the program was imported from {package}, outside the checkout",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", setup)
    leaked = sorted(set(harness.forbidden_modules())
                    | set(result.get("ranks", {}).get("forbidden", [])))
    if leaked:
        print(f"run.py: forbidden modules loaded: {', '.join(leaked)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 4 if result.get("ranks", {}).get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
