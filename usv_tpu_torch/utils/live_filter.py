"""Streaming IIR filtering — port of ``usv_tpu/utils/live_filter.py``.

Two forms of the reference's ``LiveLFilter`` (utils/live_filter.py:20-40):

* :class:`LiveLFilter` — the same stateful scalar difference-equation filter
  (host-side NumPy, for an adapter or an interactive tool), copied.
* :func:`iir_filter_scan` — the batched form: filter a whole (batched)
  signal over its leading time axis on the signal's device, for action
  smoothing of vectorized envs. The JAX module runs it as a ``lax.scan``;
  here it is a loop over time of tensor ops.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


class LiveFilter:
    """Base class: NaN passthrough + __call__ sugar (reference :4-18)."""

    def process(self, x):
        if np.isnan(x):
            return x
        return self._process(x)

    def __call__(self, x):
        return self.process(x)

    def _process(self, x):
        raise NotImplementedError


class LiveLFilter(LiveFilter):
    """Difference-equation filter from scipy-style (b, a) coefficients."""

    def __init__(self, b, a):
        self.b = np.asarray(b, dtype=np.float64)
        self.a = np.asarray(a, dtype=np.float64)
        self._xs = deque([0.0] * len(b), maxlen=len(b))
        self._ys = deque([0.0] * (len(a) - 1), maxlen=len(a) - 1)

    def _process(self, x):
        self._xs.appendleft(x)
        y = np.dot(self.b, self._xs) - np.dot(self.a[1:], self._ys)
        y = y / self.a[0]
        self._ys.appendleft(y)
        return y


def iir_filter_scan(b, a, signal, zi=None):
    """Apply the same difference equation over the leading time axis.

    signal: (T,) or (T, B...) tensor; returns (filtered_signal, final_state)
    where state is (xs, ys) ring contents, newest first. Equivalent per
    sample to LiveLFilter."""
    b = torch.as_tensor(b, dtype=signal.dtype, device=signal.device)
    a = torch.as_tensor(a, dtype=signal.dtype, device=signal.device)
    nb, na = b.shape[0], a.shape[0] - 1
    tail_shape = signal.shape[1:]
    if zi is None:
        xs = torch.zeros((nb,) + tail_shape, dtype=signal.dtype, device=signal.device)
        ys = torch.zeros((na,) + tail_shape, dtype=signal.dtype, device=signal.device)
    else:
        xs, ys = zi
    out = []
    for x in signal:
        xs = torch.cat([x[None], xs[:-1]], dim=0)
        y = (torch.tensordot(b, xs, dims=([0], [0]))
             - torch.tensordot(a[1:], ys, dims=([0], [0]))) / a[0]
        ys = torch.cat([y[None], ys[:-1]], dim=0)
        out.append(y)
    return torch.stack(out), (xs, ys)
