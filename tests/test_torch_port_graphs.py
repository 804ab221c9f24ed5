"""The port's one CUDA-graph mechanism (utils/graphs.py), on the CPU.

A stand-in takes the place of the captured graph, so that `run`'s choice,
counters and registry are held without a card: how a call runs for each
caller, the registry's entries per owner, which go with the owner, and a
new weight signature that evicts the owner's older graphs and leaves other
owners' alone. The captures and replays themselves are held on the card by
tests/test_torch_port_predict_graph.py and tests/test_torch_port_flow_graph.py.
"""
import gc

import pytest
import torch

from acfm_video_3d_reconstruction_tpu_torch.utils import graphs, tracing

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
COUNTER = {"eager": "eager_calls", "capture": "graph_captures", "replay": "graph_replays"}


class _Owner:
    """What a caller keeps its graphs under (the modules, the net)."""


class _StandIn:
    """graphs._Graph without CUDA: "captures" fn(inputs) by calling it, and
    replays by calling it again."""

    made = 0

    def __init__(self, fn, inputs, read, device):
        self.fn, self.inputs, self.read = fn, inputs, read
        _StandIn.made += 1

    def replay(self, op):
        return {"op": op, "out": self.fn(self.inputs)}


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_Graph", _StandIn)


def _call(name, owner, device, own=("shape",), read=(), loads=None):
    """One graphs.run call: eager() returns "eager"; the static input is a
    list that load() appends the call's own part to (and to `loads`)."""
    def load(inputs):
        inputs.append(own)
        if loads is not None:
            loads.append(own)

    return graphs.run(name, owner, device, lambda: (own, list(read)), eager=lambda: "eager",
                      static=list, load=load, fn=len)


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

