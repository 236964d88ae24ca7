"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``usv_tpu_torch``). The run builds the program's kernel
library into the checkout's ``build/kernels/`` or loads it from there, sets
the cell up and warms it up, measures for ``--seconds``,
profiles a short slice after the window (with ``--trace 1``, or where an
end-to-end metric of the cell is read from the device's trace), compares what the
window produced with the plain reference, and prints one JSON line: the
cell's end-to-end metrics (``--trace 0``) or its per-layer ones (``--trace
1``). Each number compared is printed beside its limit as the last lines on
standard error. Without a CUDA device, or with fewer than the cell asks for,
it prints no result and exits with 2; with JAX or the JAX package loaded once
the window has closed, with 3.
"""

import time

STARTED_AT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    # one process with one host thread of its own: the program's work is on
    # the card, and idle worker threads only add to the host's noise
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    line, checks = harness.run_cell(manifest, cell, args.seed, args.seconds, bool(args.trace),
                                    STARTED_AT)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"modules of JAX or the JAX package loaded: {foreign}", file=sys.stderr)
        return 3
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    print(json.dumps(line), flush=True)
    for text in harness.checks_text(checks):
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
