"""The control of the comparison that decides ``correct``, run at the
cell's own size under its own traffic: for an env cell the plain reference
put in the program's place and computed in bfloat16, the nearest precision
below the configuration's float32; for the SAC cell the program with its
matrix products in TF32 (the nets run float32 with TF32 off). Its readings
have to fail the limits that sound runs of the program keep; so do those of
the faults planted in the learner (``--fault``).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \\
        --seconds 3 --out <file.json>

runs the program on each of ``--seeds`` and the control on each of
``--control-seeds``, one short window each, in one process, and writes every
reading with, for each number, the largest over the program's seeds (the
lower reading) and the least over the control's or the fault's (the upper
reading). The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


class ReferenceBatch:
    """``BatchedEnv``'s interface over the reference in ``dtype``: the same
    generator, one block of reset draws a step."""

    def __init__(self, config: dict, num_envs: int, device, dtype=torch.bfloat16):
        from benchmark import harness

        self.ref, self.cfg = harness.reference_of(config), config
        self.shape = (num_envs, self.ref.n_uniform(config))
        self.device, self.dtype = device, dtype
        self.generator = None

    def _draw(self):
        u = torch.rand(self.shape, generator=self.generator, dtype=torch.float32, device=self.device)
        return u.to(self.dtype)

    def reset(self, generator):
        self.generator = generator
        state = self.ref.reset_from_uniform(self.cfg, self._draw())
        return types.SimpleNamespace(env=state), self.ref.reset_obs(self.cfg, state)

    def step(self, state, actions):
        from benchmark.reference.autoreset import auto_step

        new, out = auto_step(self.ref, self.cfg, state.env, actions.to(self.dtype), self._draw())
        return types.SimpleNamespace(env=new), types.SimpleNamespace(**out)


class ReferenceGym:
    """The gym adapter's interface (``reset(seed=)``, ``step``, ``_state``)
    over the reference in ``dtype``, reset draws made as the adapter makes
    them."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        from benchmark import harness

        self.ref, self.cfg, self.device, self.dtype = harness.reference_of(config), config, device, dtype
        self._state = None

    def reset(self, seed):
        g = torch.Generator().manual_seed(int(seed))
        u = torch.rand((1, self.ref.n_uniform(self.cfg)), generator=g).to(self.device)
        self._state = self.ref.reset_from_uniform(self.cfg, u.to(self.dtype))
        return self.ref.reset_obs(self.cfg, self._state)[0].float().cpu().numpy(), {}

    def step(self, action):
        a = torch.as_tensor(action[None], device=self.device).to(self.dtype)
        self._state, out = self.ref.step(self.cfg, self._state, a)
        return (out["obs"][0].float().cpu().numpy(), float(out["reward"][0]),
                bool(out["terminated"][0]), bool(out["truncated"][0]), {})


def tf32_learner(config: dict, device):
    """The SAC learner with its matrix products in TF32: the program's own
    path one precision below float32 with TF32 off. The check turns it off
    again before the reference runs."""
    from benchmark.drivers import sac_train

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return sac_train.program(config, device)


def control_system(driver_name: str):
    """The factory a driver takes as ``system=`` for the control."""
    if driver_name == "rollout":
        return lambda config, num_envs, device: ReferenceBatch(config, num_envs, device)
    if driver_name == "gym_loop":
        return lambda config, device: ReferenceGym(config, device)
    if driver_name == "sac_train":
        return tf32_learner
    raise KeyError(f"no control for driver {driver_name!r}")


def faulty_learner(fault: str):
    """The SAC learner with one fault planted: ``half_batch`` (each update's
    losses the means over the first half of its batch), ``frozen`` (an update
    that leaves the state unchanged) or ``altered`` (one observation entry and
    one reward of each collect step altered where the env produces them)."""

    def build(config: dict, device):
        from benchmark.drivers import sac_train

        learner = sac_train.program(config, device)
        if fault == "half_batch":
            inner = learner._sample

            def sample(ts, batch_size, d, seed):
                batch, noise, total = inner(ts, batch_size, d, seed)
                half = batch_size // 2
                return ({k: v[:half] for k, v in batch.items()},
                        {k: v[:half] for k, v in noise.items()}, total)

            learner._sample = sample
        elif fault == "frozen":
            learner._update_once = lambda ts, batch_size=None, draws=None, trace=None: ts
        elif fault == "altered":
            inner = learner.benv.step

            def step(batch, actions, generator=None, uniform=None):
                out_batch, out = inner(batch, actions, generator=generator, uniform=uniform)
                obs, frames, reward = out.obs.clone(), out_batch.frames.clone(), out.reward.clone()
                obs[0, 0] += 0.01
                frames[0, -1, 0] += 0.01
                reward[0] += 0.01
                return (dataclasses.replace(out_batch, frames=frames),
                        dataclasses.replace(out, obs=obs, reward=reward))

            learner.benv.step = step
        else:
            raise KeyError(fault)
        return learner

    return build


def readings(cell_name: str, seeds, seconds: float, control: bool, device="cuda", fault=None):
    """One reading dict per seed: a short window of the cell, then the check,
    of the program, the control, or (``fault``) the learner with a fault."""
    from benchmark import harness

    manifest = harness.load_manifest(ROOT)
    cell = harness.cell_of(manifest, cell_name)
    config, traffic = harness.config_of(manifest, cell), harness.traffic_of(cell)
    driver = harness.driver_of(traffic)
    kw = {"system": control_system(traffic["driver"])} if control else {}
    if fault:
        kw = {"system": faulty_learner(fault)}
    out = []
    for seed in seeds:
        t = time.perf_counter()
        run = driver.Cell(config, traffic, seed, torch.device(device), **kw)
        window = run.window(seconds)
        run.release()
        reading = run.check()
        out.append({"seed": seed, "attempted": window["attempted"], "readings": reading,
                    "seconds": time.perf_counter() - t})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=("half_batch", "frozen", "altered"),
                   help="run the control seeds with this fault planted in the learner instead")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    parse = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    program = readings(args.workload, parse(args.seeds), args.seconds, control=False)
    control = readings(args.workload, parse(args.control_seeds), args.seconds,
                       control=not args.fault, fault=args.fault)
    names = (program or control)[0]["readings"].keys()
    summary = {
        "workload": args.workload,
        "device": torch.cuda.get_device_name(),
        "lower": {k: max(r["readings"][k] for r in program) for k in names} if program else None,
        "upper": {k: min(r["readings"][k] for r in control) for k in names} if control else None,
        "program": program, "control": control,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in ("workload", "lower", "upper")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
