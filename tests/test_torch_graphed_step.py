"""The graphed full-width auto-reset step (``envs/autoreset.py::
GraphedAutoResetStep``) and how ``BatchedEnv`` chooses it, on the CPU at
small shapes.

A CUDA graph needs the card, so these tests stand in a graph that replays by
calling the captured function again and writing its results into the
tensors the capture returned, as a replay rewrites the graph's memory. The
rest is the program's own: the draw, the copies in, the select into a flat
buffer, the copies out.

* For every registered id, from the generator and from ``uniform`` blocks:
  bit for bit the eager auto-reset step over auto-reset waves, the generator
  left where the eager step leaves it, nothing returned overwritten by later
  steps, the input state untouched; a step from an older state, not the one
  the graph last returned, too.
* One graph per input signature; a capture that fails raises; what a step
  returns saves with ``torch.save``.
* ``BatchedEnv`` on CPU tensors steps eagerly, its reset drawn from the
  generator or handed in as ``uniform``: each step raises
  ``timing.env_step_counter.eager`` by one and builds no graph.
"""

import dataclasses

import pytest
import torch

from usv_tpu_torch import timing
from usv_tpu_torch.envs import make, registered_ids
from usv_tpu_torch.envs.autoreset import GraphedAutoResetStep, _Layout, make_autoreset_step
from usv_tpu_torch.envs.types import reset_uniform
from usv_tpu_torch.vector import BatchedEnv

B, T = 8, 14
# two TimeLimit waves in T steps; the legacy ids have no step limit, a
# cross-track bound ends their episodes
SHORT = {"usv-asmc-v0": dict(max_ye=0.05), "usv-pid-v0": dict(max_ye=0.05),
         "usv-asmc-ye-int-v0": dict(max_ye=0.05)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tensors(tree):
    """Every tensor of a state, a TimeStep or a list of them, dicts by key."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensors(getattr(tree, f.name))]
    return []


def assert_bitwise(got, want):
    got, want = tensors(got), tensors(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        bits = [x.contiguous().reshape(-1).view(torch.uint8) for x in (g, w)]
        assert torch.equal(*bits)


class StandInGraph:
    """Replays by calling ``fn`` and writing what it returns into ``out``,
    the tensors the capture returned (those it shares with its inputs or
    with cached constants are left as they are)."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        for kept, new in zip(tensors(self.out), tensors(self.fn())):
            if kept.data_ptr() != new.data_ptr():
                kept.copy_(new)
        self.replays += 1


@pytest.fixture
def graphs(monkeypatch):
    """Stand-in captures, in the order made."""
    made = []

    def capture(fn, calls=1):
        fn()  # the warm-up call
        graph = StandInGraph(fn, fn())
        made.append(graph)
        return graph, {}, graph.out

    monkeypatch.setattr(timing, "capture", capture)
    return made


def handle(env_id):
    return make(env_id, device="cpu", **SHORT.get(env_id, dict(max_episode_steps=6)))


def graphed_and_eager(h):
    fns = (h.cfg, h.step, h.reset_from_uniform, h.reset_obs, h.n_uniform(h.cfg))
    return GraphedAutoResetStep(*fns), make_autoreset_step(*fns)


def actions_of(h, generator):
    low, high = torch.tensor(h.cfg.action_low), torch.tensor(h.cfg.action_high)
    return low + torch.rand((B, h.cfg.action_dim), generator=generator) * (high - low)


@pytest.mark.parametrize("form", ["generator", "uniform"])
@pytest.mark.parametrize("env_id", registered_ids())
def test_graphed_step_is_the_eager_step(graphs, env_id, form):
    h = handle(env_id)
    graphed, eager = graphed_and_eager(h)
    n = h.n_uniform(h.cfg)
    state = want_state = h.reset(h.cfg, torch.Generator().manual_seed(3), B, torch.device("cpu"))
    gen, eager_gen = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    draws = torch.Generator().manual_seed(5)
    held, done_rows = [], 0
    for t in range(T):
        actions = actions_of(h, draws)
        uniform = torch.rand((B, n), generator=draws) if form == "uniform" else None
        inputs = [x.clone() for x in tensors(state)]
        want_state, want = eager(want_state, actions, eager_gen, uniform)
        state_in = state
        state, ts = graphed(state, actions, gen, uniform)
        assert_bitwise(state_in, inputs)
        assert torch.equal(gen.get_state(), eager_gen.get_state())
        assert_bitwise(state, want_state)
        assert_bitwise(ts, want)
        done_rows += int(want.done.sum())
        held.append((state, ts, [x.clone() for x in tensors((state, ts))]))
        if len(held) > 3:
            old_state, old_ts, snapshot = held.pop(0)
            assert_bitwise((old_state, old_ts), snapshot)
    assert done_rows >= 2 * B
    (graph,) = graphs
    assert graph.replays == T


def test_a_step_from_an_older_state_is_the_eager_step(graphs):
    h = handle("usv-asmc-ca-v0")
    graphed, eager = graphed_and_eager(h)
    state = h.reset(h.cfg, torch.Generator().manual_seed(3), B, torch.device("cpu"))
    actions = actions_of(h, torch.Generator().manual_seed(5))
    states = [state]
    for t in range(7):
        states.append(graphed(states[-1], actions, torch.Generator().manual_seed(t))[0])
    for old in (states[2], states[5], states[0]):
        got = graphed(old, actions, torch.Generator().manual_seed(9))
        want = eager(old, actions, torch.Generator().manual_seed(9))
        assert_bitwise(got, want)


def test_one_graph_per_input_signature(graphs):
    h = handle("usv-simple")
    graphed, _ = graphed_and_eager(h)
    state = h.reset(h.cfg, torch.Generator().manual_seed(3), B, torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    actions = torch.zeros((B, 2))
    for _ in range(3):
        state, _ = graphed(state, actions, g)
    assert len(graphs) == 1
    graphed(state, actions.double(), g)  # another action dtype
    graphed(state, actions, uniform=torch.rand((B, h.n_uniform(h.cfg)), dtype=torch.float64))
    narrow = h.reset(h.cfg, g, B - 2, torch.device("cpu"))
    graphed(narrow, actions[:B - 2], g)
    graphed(state, actions, g)
    assert len(graphs) == len(graphed.graphs) == 4


def test_a_capture_that_fails_raises(monkeypatch):
    def capture(fn, calls=1):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(timing, "capture", capture)
    h = handle("usv-simple")
    graphed, _ = graphed_and_eager(h)
    state = h.reset(h.cfg, torch.Generator().manual_seed(3), B, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="capturing"):
        graphed(state, torch.zeros((B, 2)), torch.Generator().manual_seed(1))


def test_layout_places_each_tensor_aligned_and_apart():
    metas = [(torch.Size([5, 3]), torch.float32), (torch.Size([5]), torch.bool),
             (torch.Size([5, 2, 2]), torch.int64), (torch.Size([]), torch.float32)]
    flats, views = _Layout(metas).new("cpu")
    assert set(flats) == {torch.float32, torch.bool, torch.int64}
    spans = {}
    for (shape, dtype), v in zip(metas, views):
        assert v.shape == shape and v.dtype == dtype and v.is_contiguous()
        flat = flats[dtype]
        assert v.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
        offset = v.data_ptr() - flat.data_ptr()
        assert offset % 256 == 0
        spans.setdefault(dtype, []).append((offset, offset + v.numel() * v.element_size()))
    for dtype, ends in spans.items():
        ends.sort()
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert ends[-1][1] <= flats[dtype].numel() * flats[dtype].element_size()
    for i, v in enumerate(views):
        v.fill_(i + 1)
    assert [int(v.reshape(-1)[0]) for v in views] == [1, 1, 3, 4]  # bool 2 reads True


def test_a_returned_state_and_timestep_save_and_load(graphs):
    """``torch.save`` refuses one storage viewed as two dtypes: what a step
    returns (checkpointed with a learner's state) must save."""
    import io

    h = handle("usv-asmc-ca-v0")
    graphed, _ = graphed_and_eager(h)
    state = h.reset(h.cfg, torch.Generator().manual_seed(3), B, torch.device("cpu"))
    for t in range(3):
        state, ts = graphed(state, actions_of(h, torch.Generator().manual_seed(t)),
                            torch.Generator().manual_seed(t))
    buf = io.BytesIO()
    torch.save({"state": state, "ts": ts}, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    assert_bitwise((back["state"], back["ts"]), (state, ts))


@pytest.mark.parametrize("draw", ["generator", "uniform"])
def test_batched_env_on_cpu_steps_eagerly(monkeypatch, draw):
    def refuse(fn, calls=1):
        raise AssertionError("a CUDA graph was captured for CPU tensors")

    monkeypatch.setattr(timing, "capture", refuse)
    h = make("usv-asmc-ca-v0", device="cpu", max_episode_steps=3)
    benv = BatchedEnv(h, 4, frame_stack=2)
    state, _ = benv.reset(0)
    blocks = torch.Generator().manual_seed(6)
    counter = timing.env_step_counter
    replayed, eager = counter.replayed, counter.eager
    for k in range(1, 6):
        uniform = None
        if draw == "uniform":
            uniform = reset_uniform(blocks, 4, h.n_uniform(h.cfg), "cpu")
        state, _ = benv.step(state, torch.zeros((4, 2)), uniform=uniform)
        assert (counter.replayed, counter.eager) == (replayed, eager + k)
    assert benv._graphed.graphs == {}
