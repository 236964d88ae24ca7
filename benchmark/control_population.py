"""The control of the comparison that decides ``correct`` in the seed
population's cell (``simple-sac-pop4``, driver ``sac_population``), beside
``control.py``'s for the other cells: the program's matrix products in TF32
(the nets run float32 with TF32 off), two faults planted in the population
learner, and the plain reference computed in bfloat16. Their readings have
to fail limits that sound runs of the program keep.

    python3 benchmark/control_population.py --seeds 1,2,3 --control-seeds 4,5,6 \\
        --seconds 3 --out <file.json>

runs the program on each of ``--seeds``, then each control of
``--controls`` on each of ``--control-seeds``, one short window each, in one
process, and writes every reading with, for each number, the largest over
the program's seeds (the lower reading) and, for each control, the least
over its seeds (the upper reading). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CONTROLS = ("tf32", "half_batch", "shared_stream", "bfloat16")


def faulty(kind: str):
    """The ``system=`` factory of one control: ``tf32`` (the program's
    matrix products in TF32), ``half_batch`` (each update's losses the means
    over the first half of every member's batch), ``shared_stream`` (member
    1 draws from member 0's generator), or ``bfloat16`` (the program as it
    is: the control is the reference's precision)."""
    from benchmark import control
    from benchmark.drivers import sac_population

    if kind == "tf32":
        return control.tf32_learner

    def build(config: dict, device):
        learner = sac_population.program(config, device)
        if kind == "half_batch":
            inner = learner._update_draws_many

            def draws(ps, batch_size):
                d = inner(ps, batch_size)
                return {k: v[:, :batch_size // 2] for k, v in d.items()}

            learner._update_draws_many = draws
        elif kind == "shared_stream":
            init_many = learner.init_many

            def init(seeds):
                ps = init_many(seeds)
                ps.generators[1] = ps.generators[0]
                return ps

            learner.init_many = init
        elif kind != "bfloat16":
            raise KeyError(kind)
        return learner

    return build


def readings(cell_name: str, seeds, seconds: float, kind=None, device="cuda"):
    """One reading dict per seed: a short window of the cell, then the check,
    of the program or (``kind``) of one control."""
    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, cell_name)
    config, traffic = harness.config_of(manifest, cell), harness.traffic_of(cell)
    driver = harness.driver_of(traffic)
    kw = {"system": faulty(kind)} if kind else {}
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    out = []
    for seed in seeds:
        t = time.perf_counter()
        run = driver.Cell(config, traffic, seed, torch.device(device), **kw)
        window = run.window(seconds)
        run.release()
        reading = run.check(dtype)
        out.append({"seed": seed, "control": kind, "attempted": window["attempted"],
                    "readings": reading, "seconds": time.perf_counter() - t})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="simple-sac-pop4")
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--controls", default=",".join(CONTROLS))
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    parse = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    program = readings(args.workload, parse(args.seeds), args.seconds)
    controls = {kind: readings(args.workload, parse(args.control_seeds), args.seconds, kind)
                for kind in args.controls.split(",") if kind}
    runs = program or next(iter(controls.values()))
    names = runs[0]["readings"].keys()
    summary = {
        "workload": args.workload,
        "device": torch.cuda.get_device_name(),
        "lower": {k: max(r["readings"][k] for r in program) for k in names} if program else None,
        "upper": {kind: {k: min(r["readings"][k] for r in rs) for k in names}
                  for kind, rs in controls.items() if rs},
        "program": program, "controls": controls,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("workload", "lower", "upper")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
