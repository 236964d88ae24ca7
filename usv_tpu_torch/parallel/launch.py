"""Start rank processes as a launcher does, and collect what they return.

:func:`run_ranks` runs ``module:function`` in ``n`` fresh Python processes,
each given the environment torchrun gives a rank (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), so that the function's
bare :func:`~usv_tpu_torch.parallel.dist.initialize_distributed` (or
``run_sac.main``) brings the group up. It returns each rank's return value,
in rank order. A rank that fails, or a run past its time limit, fails the
call: every process it started is killed first, and the error carries the
failing rank's last output.

The child side is this module run as a script::

    python -m usv_tpu_torch.parallel.launch <spec.pt> <result.pt>
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import List, Optional, Sequence

import torch

PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, limit: int = 4000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-limit:]


def run_ranks(target: str, n: int, kwargs: Optional[dict] = None, timeout: float = 120.0,
              paths: Sequence[str] = (), echo: bool = False) -> List[object]:
    """``target(**kwargs)`` on ``n`` ranks, each with one intra-op thread
    (ranks share the host's cores); returns their results in rank order.
    ``paths`` go ahead of ``sys.path`` in the children (where ``target``'s
    module lives); ``echo`` prints rank 0's output after it ends."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="usv_ranks_") as tmp:
        tmp = Path(tmp)
        spec = tmp / "spec.pt"
        torch.save({"target": target, "kwargs": kwargs or {}}, spec)
        env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join([*paths, PACKAGE_ROOT,
                                               *filter(None, [os.environ.get("PYTHONPATH")])]))
        procs = []
        try:
            for rank in range(n):
                with open(tmp / f"out{rank}.txt", "w") as out, open(tmp / f"err{rank}.txt", "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "usv_tpu_torch.parallel.launch", str(spec),
                         str(tmp / f"result{rank}.pt")],
                        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                        stdout=out, stderr=err, stdin=subprocess.DEVNULL))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    rank = failed[0] if failed else 0
                    why = (f"rank {rank} exited with {procs[rank].returncode}" if failed
                           else f"timed out after {timeout:.0f} s")
                    raise RuntimeError(f"{target} on {n} ranks: {why}\n{_tail(tmp / f'err{rank}.txt')}")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                rank = failed[0]
                raise RuntimeError(f"{target} on {n} ranks: rank {rank} exited with "
                                   f"{procs[rank].returncode}\n{_tail(tmp / f'err{rank}.txt')}")
            if echo:
                print(_tail(tmp / "out0.txt", 20000), end="", flush=True)
            return [torch.load(tmp / f"result{r}.pt", weights_only=False) for r in range(n)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _child(spec_path: str, result_path: str) -> int:
    spec = torch.load(spec_path, weights_only=False)  # written by run_ranks
    torch.set_num_threads(1)
    module, name = spec["target"].split(":")
    try:
        result = getattr(importlib.import_module(module), name)(**spec["kwargs"])
        torch.save(result, result_path)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    finally:
        from usv_tpu_torch.parallel.dist import shutdown_distributed

        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(_child(*sys.argv[1:3]))
