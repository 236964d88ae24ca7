"""Cost attribution and unroll rows for ``usv-asmc-simple`` — port of
``tools/bench_asmc_simple.py``.

Measures, in one process, through :func:`usv_tpu_torch.vector.throughput`:

  - ``usv-simple`` (the same-process scale reference)
  - ``usv-simple ignore_obstacles`` (the base env less its sensor)
  - ``usv-asmc-simple unroll=<u>`` for each ``--unrolls`` value
  - ``usv-asmc-simple ignore_obstacles`` (the sensor's share)

Attribution: substep cost = asmc(ignore) - simple(ignore); sensor cost =
asmc(default) - asmc(ignore). With ``ignore_obstacles`` the port casts no
ray (``envs/simple.py::_sensor_sweep``), as XLA drops the unused cast in
JAX, so the sensor cost holds the kernel's launch.

``substep_unroll`` is the unroll factor of JAX's ``lax.scan`` over the 20
controller+model substeps (``usv_tpu/envs/simple_asmc.py``). The port keeps
the config field (``usv_tpu_torch/envs/simple_asmc.py``) but its substeps are
a Python loop of eager calls whatever the field says, so the unroll rows run
one and the same program: their spread is the run-to-run spread.

Usage (on the card unless ``--device`` names another)::

    python -m usv_tpu_torch.tools.bench_asmc_simple [--envs 4096] \\
        [--steps 2048] [--unrolls 1 4 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

ROW_KEYS = ("config", "ms_per_batched_step", "steps_per_second")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--unrolls", type=int, nargs="*", default=[1, 4, 20])
    p.add_argument("--device", default=None, help="torch device; default the CUDA device")
    return p


def configs(unrolls):
    """``(config label, env id, make overrides)`` of every row, in order."""
    rows = [("usv-simple", "usv-simple", {}),
            ("usv-simple ignore_obstacles", "usv-simple", {"ignore_obstacles": True})]
    rows += [(f"usv-asmc-simple unroll={u}", "usv-asmc-simple", {"substep_unroll": u})
             for u in unrolls]
    rows.append(("usv-asmc-simple ignore_obstacles", "usv-asmc-simple", {"ignore_obstacles": True}))
    return rows


def main(argv=None) -> list:
    """Print one JSON line per row; returns the rows."""
    args = build_parser().parse_args(argv)
    from usv_tpu_torch.envs import make
    from usv_tpu_torch.envs.registry import resolve_device
    from usv_tpu_torch.vector import throughput

    device = resolve_device(args.device)
    rows = []
    for tag, env_id, kw in configs(args.unrolls):
        out = throughput(make(env_id, device=device, **kw), num_envs=args.envs,
                         n_steps=args.steps, repeats=3)
        rows.append({
            "config": tag,
            "ms_per_batched_step": round(1e3 * args.envs / out["steps_per_second"], 4),
            "steps_per_second": round(out["steps_per_second"], 1),
        })
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
