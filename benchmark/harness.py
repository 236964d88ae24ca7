"""The benchmark's general machinery: the manifest and the files it names,
the window arithmetic, the profiled slice and its reduction, the comparison
with the plain reference, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose file is ``configs/<config>.json``, and a traffic mix,
whose file is ``traffic/<traffic>.json``. The traffic file names its driver,
``drivers/<driver>.py``, which builds the program under test, warms it up,
runs the timed window, profiles a slice after it and compares what the window
produced with the reference. Each metric has a reader, ``metrics/<name>.py``
or, for a name with a dot, ``metrics/<name up to the dot>.py``: ``read(record)``
returns a number, or ``None`` where the record holds nothing to read.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FOREIGN = ("jax", "jaxlib", "flax", "usv_tpu")
TOP_OPS, TOP_GAPS = 10, 10


# ---------------------------------------------------------------- manifest

def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r}; the manifest has "
                   f"{[c['name'] for c in manifest['workloads']]}")


def config_of(manifest: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return json.loads((root / entry["file"]).read_text())


def traffic_of(cell: dict) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())


def driver_of(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def reference_of(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def metrics_of(manifest: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    return [m for m in manifest["per_layer" if trace else "end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader_of(name: str):
    """``read`` of ``metrics/<name>.py``, else of ``metrics/<name up to its
    first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        if (BENCH_DIR / "metrics" / f"{stem}.py").exists():
            return importlib.import_module(f"benchmark.metrics.{stem}").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH_DIR / 'metrics'}")


# ------------------------------------------------------------- arithmetic

def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to [lo, hi]."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def gaps(intervals, lo: float, hi: float):
    """The ``(start, end)`` stretches of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


class Reservoir:
    """A uniform sample of ``k`` of the steps of a window whose length is not
    known in advance, drawn from a seed: :meth:`admit` says, before step
    ``i`` runs, whether it is kept and which place it takes."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: list = []

    def admit(self, i: int) -> Optional[int]:
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, place: int, item) -> None:
        if place == len(self.items):
            self.items.append(item)
        else:
            self.items[place] = item


def derived_seed(seed: int, tag: int) -> int:
    """A seed of its own for one stream of a run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2**63, tag]).generate_state(1, np.uint64)[0] >> 1)


# -------------------------------------------------------------- states

def flatten(state, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensor leaves of a (nested) dataclass or dict state under dotted
    field names."""
    if state is None:
        return {}
    if dataclasses.is_dataclass(state):
        items = ((f.name, getattr(state, f.name)) for f in dataclasses.fields(state))
    elif isinstance(state, dict):
        items = state.items()
    else:
        return {prefix[:-1]: state}
    out = {}
    for name, value in items:
        out.update(flatten(value, f"{prefix}{name}."))
    return out


def as_float32(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() if v.is_floating_point() else v for k, v in leaves.items()}


# ------------------------------------------------------------ comparison

class Comparison:
    """The numbers that decide ``correct``, each the worst over every answer
    compared: ``obs_gap`` (the largest |difference| of an observation entry
    other than a ray), ``ray_miss_share`` (the share of ray readings more
    than ``RAY_TOL`` apart), ``reward_gap``, ``state_gap`` (the largest
    |difference| / (1 + |reference|) of a float state leaf other than the
    rays and the observation it holds) and ``discrete_mismatch`` (rows whose
    flags, counters or masks differ)."""

    RAY_TOL = 1e-3
    NAMES = ("obs_gap", "ray_miss_share", "reward_gap", "state_gap", "discrete_mismatch")
    SKIP_LEAVES = ("sensor_dist", "state_vec")

    def __init__(self, sensor_columns):
        self.lo, self.hi = sensor_columns
        self.worst = dict.fromkeys(("obs_gap", "reward_gap", "state_gap", "discrete_mismatch"), 0.0)
        self.rays = self.rays_apart = 0

    def _max(self, name, value):
        value = float(value)
        self.worst[name] = max(self.worst[name], math.inf if math.isnan(value) else value)

    def obs(self, got, want):
        got, want = torch.as_tensor(got).float().to(want.device), want.float()
        diff = (got - want).abs()
        diff = torch.where(torch.isnan(got) | torch.isnan(want), math.inf, diff)
        rest = torch.cat([diff[:, :self.lo], diff[:, self.hi:]], 1)
        if rest.numel():
            self._max("obs_gap", rest.max())
        rays = diff[:, self.lo:self.hi]
        self.rays += rays.numel()
        self.rays_apart += int((~(rays <= self.RAY_TOL)).sum())

    def outputs(self, got: dict, want: dict):
        """``got`` and ``want`` hold obs, reward, terminated, truncated."""
        self.obs(got["obs"], want["obs"])
        r_got = torch.as_tensor(got["reward"]).float().to(want["reward"].device).reshape(-1)
        diff = (r_got - want["reward"].float().reshape(-1)).abs()
        self._max("reward_gap", torch.nan_to_num(diff, nan=math.inf).max())
        flags = torch.zeros_like(diff, dtype=torch.bool)
        for name in ("terminated", "truncated"):
            g = torch.as_tensor(got[name]).to(want[name].device).reshape(-1).bool()
            flags |= g != want[name].reshape(-1).bool()
        self.worst["discrete_mismatch"] += int(flags.sum())

    def state(self, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
        if set(got) != set(want):
            raise KeyError(f"state fields differ: {sorted(set(got) ^ set(want))}")
        rows = None
        for name, w in want.items():
            if name.split(".")[-1] in self.SKIP_LEAVES:
                continue
            g = got[name].to(w.device)
            if w.is_floating_point():
                g, w = g.float(), w.float()
                rel = (g - w).abs() / (1.0 + w.abs())
                self._max("state_gap", torch.nan_to_num(rel, nan=math.inf).max())
            else:
                bad = (g != w).reshape(w.shape[0], -1).any(1)
                rows = bad if rows is None else rows | bad
        if rows is not None:
            self.worst["discrete_mismatch"] += int(rows.sum())

    def readings(self) -> Dict[str, float]:
        out = dict(self.worst)
        out["ray_miss_share"] = self.rays_apart / self.rays if self.rays else 0.0
        return {k: out[k] for k in self.NAMES}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """One entry a compared number: its name, value, limit and whether it
    holds (a NaN never holds)."""
    return [{"name": k, "value": v, "limit": limits[k], "ok": bool(v <= limits[k])}
            for k, v in readings.items()]


# ----------------------------------------------------------- the slice

@dataclasses.dataclass
class Slice:
    """What one profiled stretch of steps shows, times in seconds."""
    steps: int
    window_s: float
    busy_s: float
    aten_calls: int
    kernel_s: Dict[str, List[float]]   # device op name -> each run's seconds
    idle_gaps: List[list]              # [label, seconds], longest first
    extra: dict = dataclasses.field(default_factory=dict)

    def kernel_durations(self, fragment: str) -> List[float]:
        return [t for name, ts in self.kernel_s.items() if fragment in name for t in ts]

    def top_ops(self, n: int = TOP_OPS) -> List[list]:
        sums = sorted(((sum(ts), name) for name, ts in self.kernel_s.items()), reverse=True)
        return [[name, total] for total, name in sums[:n]]


STEP_RANGE, SLICE_RANGE = "bench.step", "bench.slice"


def profile_slice(run_steps, steps: int) -> Slice:
    """Profile ``run_steps()``, which runs ``steps`` steps each inside
    ``torch.profiler.record_function(STEP_RANGE)``, between two synchronizes.
    The aten calls counted are those that start inside a step's range. An
    idle gap is labelled with the innermost aten op running on the host at
    its middle, or else with the last one that started before it."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(SLICE_RANGE):
                torch.cuda.synchronize()
                run_steps()
                torch.cuda.synchronize()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    lo, hi = next((e.time_range.start, e.time_range.end) for e in cpu if e.name == SLICE_RANGE)
    ranges = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == STEP_RANGE)
    if len(ranges) != steps:
        raise RuntimeError(f"the slice shows {len(ranges)} steps, expected {steps}")
    starts = [a for a, _ in ranges]
    aten = [e for e in cpu if e.name.startswith("aten::")]

    def in_step(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    calls = sum(1 for e in aten if in_step(e.time_range.start))
    # the device side of a record_function range (a GPU user annotation, the
    # benchmark's own or the program's, such as the optimizer's step) is no operation
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in (STEP_RANGE, SLICE_RANGE)]
    if not device:
        raise RuntimeError("the profiler saw no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    kernel_s: Dict[str, List[float]] = {}
    for e in device:
        kernel_s.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e6)
    busy = union_length(spans, lo, hi)
    a_start = np.array([e.time_range.start for e in aten], dtype=np.float64)
    a_end = np.array([e.time_range.end for e in aten], dtype=np.float64)
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP_GAPS]
    labelled = []
    for a, b in idle:
        mid = (a + b) / 2
        covering = np.flatnonzero((a_start <= mid) & (a_end >= mid))
        if covering.size:
            label = aten[covering[np.argmax(a_start[covering])]].name
        else:
            before = np.flatnonzero(a_start <= mid)
            label = ("after " + aten[before[np.argmax(a_start[before])]].name if before.size
                     else "host")
        labelled.append([label, (b - a) / 1e6])
    return Slice(steps=steps, window_s=(hi - lo) / 1e6, busy_s=busy / 1e6, aten_calls=calls,
                 kernel_s=kernel_s, idle_gaps=labelled)


# ------------------------------------------------------------- the run

@dataclasses.dataclass
class Record:
    """What a reader reads: the window, the slice (traced runs only), the
    set-up time and what the driver adds for its readers."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window: dict
    slice: Optional[Slice] = None


def synchronize(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


@contextlib.contextmanager
def quiet_host():
    """Keep the host from adding noise to the window: this thread stays on one
    core (the last it may use; the CUDA driver's threads keep the rest), and
    the garbage collector, after one collection with what set-up made frozen
    out of its reach, stays off. Both come back when the window closes."""
    cores = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cores)})
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
        os.sched_setaffinity(0, cores)


def run_cell(manifest: dict, cell: dict, seed: int, seconds: float, trace: bool,
             started_at: float, device="cuda"):
    """One run of ``cell`` -> (result line without ``checks``, judged checks).
    ``started_at`` is the process's start on ``time.perf_counter``'s clock."""
    config, traffic = config_of(manifest, cell), traffic_of(cell)
    driver = driver_of(traffic)
    device = torch.device(device)
    torch.cuda.reset_peak_memory_stats(device)
    run = driver.Cell(config, traffic, seed, device)
    wanted = metrics_of(manifest, cell, trace)
    with quiet_host():
        window = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device)
    # an end-to-end metric read from the device's trace has its slice profiled
    # in an untraced run too
    sliced = trace or any(m["source"] == "device_trace" for m in wanted)
    profiled = run.profile() if sliced else None
    run.release()
    checks = judge(run.check(), config["limits"][driver.LIMITS])
    record = Record(cell=cell, config=config, traffic=traffic,
                    setup_s=window["opened_at"] - started_at, window=window, slice=profiled)
    metrics = {}
    for m in wanted:
        value = reader_of(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(device_line(device), memory_peak_bytes=int(peak))
    line = {"correct": all(c["ok"] for c in checks), "attempted": int(window["attempted"]),
            "failed": int(window.get("failed", 0)), "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=profiled.busy_s, window_s=profiled.window_s)
        line["breakdown"] = {"device_ops": profiled.top_ops(), "idle_gaps": profiled.idle_gaps}
    return line, checks


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``usv_tpu_torch`` is not ``usv_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FOREIGN))


def checks_text(checks: List[dict]) -> List[str]:
    return [f"{c['name']} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}"
            for c in checks]
