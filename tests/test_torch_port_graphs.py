"""The port's one CUDA-graph mechanism (utils/graphs.py), on the CPU.

A stand-in takes the place of the captured graph, so that `run`'s choice,
counters and registry are held without a card: how a call runs for each
caller, the registry's entries per owner, which go with the owner, and a
new weight signature that evicts the owner's older graphs and leaves other
owners' alone; the training case's warm-ups (the caller's own calls, no
extra run) and its eviction; and a replay's counts under tracing. The
captures and replays themselves are held on the card by
tests/test_torch_port_predict_graph.py, tests/test_torch_port_flow_graph.py
and tests/test_torch_port_train_graph.py.
"""
import gc

import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from acfm_video_3d_reconstruction_tpu_torch.utils import graphs, tracing

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
COUNTER = {"eager": "eager_calls", "capture": "graph_captures", "replay": "graph_replays"}


class _Owner:
    """What a caller keeps its graphs under (the modules, the net)."""


class _StandIn:
    """graphs._Graph without CUDA: "captures" nothing (the real one runs no
    extra time in the training case and WARMUP_RUNS otherwise), and replays
    by calling fn(inputs)."""

    made = 0

    def __init__(self, fn, inputs, read, device, train=False):
        self.fn, self.inputs, self.read, self.train = fn, inputs, read, train
        _StandIn.made += 1

    def replay(self, op):
        return {"op": op, "out": self.fn(self.inputs)}


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _StandIn)


def _call(name, owner, device, own=("shape",), read=(), loads=None, **kw):
    """One graphs.run call: eager() returns "eager"; the static input is a
    list that load() appends the call's own part to (and to `loads`)."""
    def load(inputs):
        inputs.append(own)
        if loads is not None:
            loads.append(own)

    return graphs.run(name, owner, device, lambda: (own, list(read)), eager=lambda: "eager",
                      static=list, load=load, fn=len, **kw)


def _counters(name) -> dict:
    c = tracing.counters()
    return {v: c.get(f"{name}.{v}", 0) for v in COUNTER.values()}


@pytest.mark.parametrize("caller", ["predict", "flow"])
@pytest.mark.parametrize("device_type, tracing_on, captured, want", [
    ("cpu", False, False, "eager"),
    ("cpu", True, False, "eager"),
    ("cpu", False, True, "eager"),
    ("cpu", True, True, "eager"),
    ("cuda", False, False, "capture"),
    ("cuda", True, False, "eager"),
    ("cuda", False, True, "replay"),
    ("cuda", True, True, "replay"),
])
def test_choose(stand_in, monkeypatch, caller, device_type, tracing_on, captured, want):
    """Eager off CUDA, and while tracing is on with no graph yet: tracing
    never captures. A caller's call through graphs.run takes that way, and
    counts it in the caller's own counter (a graph of the signature kept
    before, on CUDA, is never read off it)."""
    assert graphs.choose(device_type, tracing_on, captured) == want
    owner = _Owner()
    if captured:
        _call(caller, owner, CUDA)
    monkeypatch.setattr(tracing, "on", lambda: tracing_on)
    before = _counters(caller)
    got = _call(caller, owner, torch.device(device_type))
    after = _counters(caller)
    assert {k: after[k] - before[k] for k in after} == {
        v: int(v == COUNTER[want]) for v in COUNTER.values()}
    if want == "eager":
        assert got == "eager"
    else:
        assert got["op"] == f"acfm.{caller}.graph_replay"


def test_entry_leaves_with_its_owner(stand_in):
    """An owner's graphs are kept under its id while it lives, and its entry
    goes when it is collected."""
    owner = _Owner()
    _call("flow", owner, CUDA)
    key = id(owner)
    assert len(graphs._GRAPHS[key]) == 1
    del owner
    gc.collect()
    assert key not in graphs._GRAPHS


def test_new_weights_evict_the_owners_older_graphs(stand_in):
    """A capture under new read addresses evicts the owner's graphs of the
    old ones, whatever their own part, and leaves another owner's alone; a
    new own part under the same addresses keeps them."""
    w1, w2 = torch.zeros(2), torch.zeros(2)
    owner, other = _Owner(), _Owner()
    _call("predict", owner, CUDA, own=("a",), read=[w1])
    _call("predict", owner, CUDA, own=("b",), read=[w1])
    _call("predict", other, CUDA, own=("a",), read=[w1])
    assert len(graphs._GRAPHS[id(owner)]) == 2
    _call("predict", owner, CUDA, own=("a",), read=[w2])
    (key,) = graphs._GRAPHS[id(owner)]
    assert key[1] == (w2.data_ptr(),)
    assert [k[1] for k in graphs._GRAPHS[id(other)]] == [(w1.data_ptr(),)]


def test_a_graph_holds_what_it_reads(stand_in):
    """The graph keeps the tensors it reads, so that no address in its key
    is handed to another tensor while it lives."""
    owner, w = _Owner(), torch.zeros(3)
    _call("flow", owner, CUDA, read=[w])
    (graph,) = graphs._GRAPHS[id(owner)].values()
    assert len(graph.read) == 1 and graph.read[0] is w


def test_every_call_loads_its_data(stand_in):
    """The call's data goes into the static inputs before the capture and
    before each replay; off CUDA the signature is not read and nothing is
    loaded."""
    owner, loads = _Owner(), []
    made = _StandIn.made
    first = _call("predict", owner, CUDA, loads=loads)
    second = _call("predict", owner, CUDA, loads=loads)
    assert _StandIn.made == made + 1
    assert loads == [("shape",)] * 3
    assert (first["out"], second["out"]) == (2, 3)

    def unread():
        raise AssertionError("the signature was read off CUDA")

    assert graphs.run("predict", owner, CPU, unread, eager=lambda: "eager", static=unread,
                      load=unread, fn=unread) == "eager"



@pytest.mark.parametrize("device, tracing_on, captured, warmed, want", [
    ("cuda", False, False, False, "eager"),
    ("cuda", True, False, False, "eager"),
    ("cuda", False, False, True, "capture"),
    ("cuda", True, False, True, "eager"),
    ("cuda", False, True, True, "replay"),
    ("cuda", True, True, True, "replay"),
    ("cpu", False, False, True, "eager"),
    ("cpu", False, True, True, "eager"),
])
def test_choose_training_case(device, tracing_on, captured, warmed, want):
    """On CUDA: a signature not yet warmed runs eagerly, a warmed one
    captures (unless tracing is on), a captured one replays; off CUDA every
    call is eager, a graph kept or not."""
    assert graphs.choose(device, tracing_on, captured, warmed) == want


class _Step:
    """A training step's state: each call of fn is one update."""

    def __init__(self):
        self.updates = 0

    def fn(self, inputs):
        self.updates += 1
        return self.updates


def _train_call(owner, step, own=("k", 4), read=(), **kw):
    def eager():
        step.updates += 1
        return "eager"

    return graphs.run("train", owner, CUDA, lambda: (own, list(read)), eager=eager,
                      static=list, load=lambda inputs: inputs.append(own), fn=step.fn,
                      train=True, **kw)


def test_training_warmups_are_the_callers_own_calls(stand_in):
    """The training case: the first TRAIN_WARM_CALLS calls of a signature's
    own part run eagerly (each a real update), the next captures and
    replays at once, the rest replay; each call is one update (no extra
    run), and the graph is made as the training case."""
    owner, step = _Owner(), _Step()
    before = _counters("train")
    got = [_train_call(owner, step) for _ in range(4)]
    assert got[:graphs.TRAIN_WARM_CALLS] == ["eager"] * graphs.TRAIN_WARM_CALLS
    assert step.updates == 4 and got[-1] == {"op": "acfm.train.graph_replay", "out": 4}
    after = _counters("train")
    assert {k: after[k] - before[k] for k in after} == {
        "eager_calls": graphs.TRAIN_WARM_CALLS, "graph_captures": 1,
        "graph_replays": 3 - graphs.TRAIN_WARM_CALLS}
    (graph,) = graphs._GRAPHS[id(owner)].values()
    assert graph.train


def test_training_warmups_count_by_own_part_and_survive_new_addresses(stand_in):
    """A new read address (Adam's state, made by the first update) under a
    warmed own part captures with no further warm-up; another own part (k,
    a rate) warms up again."""
    owner, step = _Owner(), _Step()
    w1, w2 = torch.zeros(2), torch.zeros(2)
    assert _train_call(owner, step, read=[w1]) == "eager"
    assert _train_call(owner, step, read=[w1, w2])["op"] == "acfm.train.graph_replay"
    assert _train_call(owner, step, own=("k", 2), read=[w1, w2]) == "eager"
    assert _train_call(owner, step, own=("k", 2), read=[w1, w2])["out"] == step.updates


def test_a_training_capture_replaces_the_owners_other_graphs(stand_in):
    """A run's signature only moves forward: a training capture evicts the
    owner's graph of the old own part, and leaves another owner's alone."""
    owner, other, step = _Owner(), _Owner(), _Step()
    for _ in range(2):
        _train_call(owner, step, own=("k", 4))
        _train_call(other, step, own=("k", 4))
    for _ in range(2):
        _train_call(owner, step, own=("k", 2))
    assert [k[0] for k in graphs._GRAPHS[id(owner)]] == [("k", 2)]
    assert [k[0] for k in graphs._GRAPHS[id(other)]] == [("k", 4)]


class _FakeCUDAGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_traced_replay_adds_the_captures_counts():
    """The counts a capture collected (tracing.collect: device sums as the
    graph's outputs, traced host counts) are added by each replay while
    tracing is on, and by none while it is off."""
    graph = graphs._Graph.__new__(graphs._Graph)
    graph.graph, graph.launches, graph.outputs = _FakeCUDAGraph(), {}, torch.zeros(1)
    with tracing.collect() as graph.counts:
        tracing.count_device("solve.failures", torch.tensor([True, False, True]))
        tracing.count_device("solve.failures", torch.tensor([True]))
        tracing.count_traced("multiplex.views", 64)
    tracing.reset()
    graph.replay("acfm.train.graph_replay")
    assert "multiplex.views" not in tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            graph.replay("acfm.train.graph_replay")
    got = tracing.counters()
    assert (got["solve.failures"], got["multiplex.views"]) == (6, 128)
    assert graph.graph.replays == 3
