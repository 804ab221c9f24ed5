"""make_flow_fn's MaskFlownet pass replayed as a CUDA graph
(flow/infer.py through utils/graphs.py).

On the CPU: the signature a graph is kept under (`graph_signature` in
graphs.graph_key), and make_flow_fn's flows against clip_flows bit for
bit with no graph made. On the card, at the multiframe trainer's shapes
(8 clips x 2 frames at 256^2, the net at 384x768, seeded weights): replay
against the eager pass bit for bit, flows that later calls leave alone, a
capture beside another thread's work on the default stream, tracing, the
cost volume's launch counters and the graph counters.

This file imports neither JAX nor the JAX package, so the card's tests run
on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_flow_graph.py
"""
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from acfm_video_3d_reconstruction_tpu_torch.flow import infer as tinfer
from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as tmfn
from acfm_video_3d_reconstruction_tpu_torch.utils import graphs, tracing

torch.set_num_threads(1)

FLOW_COUNTERS = ("flow.graph_captures", "flow.graph_replays", "flow.eager_calls")
CORR = ("launch.corr_md4", "launch.corr_md2")


def _net(device="cpu", seed: int = 0) -> tmfn.MaskFlownet:
    return tmfn.build(tmfn.init_params(torch.Generator().manual_seed(seed)), device)


def _clips(seed: int, b: int, size: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """b clips of 2 frames, (b, 2, size, size, 3) in [0, 1)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((b, 2, size, size, 3), generator=g).to(device=device, dtype=dtype)


def _counters(names=FLOW_COUNTERS) -> dict:
    c = tracing.counters()
    return {k: c.get(k, 0) for k in names}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counters(tuple(before)).items()}


# -------------------------------------------------------------------- CPU --

CPU_IMG, CPU_NET_HW = 32, (64, 64)


@pytest.fixture(scope="module")
def cpu_net():
    return _net()


def _key(net, imgs, size, net_hw) -> tuple:
    return graphs.graph_key(*tinfer.graph_signature(net, imgs, size, net_hw))


@pytest.mark.parametrize("change", [
    "shape", "dtype", "image_size", "net_hw", "parameter", "matmul tf32", "cudnn tf32",
    "cudnn enabled", "deterministic"])
def test_graph_key_changes(monkeypatch, change):
    """A new key for another input shape or dtype, output size or net size,
    a replaced parameter, a flipped TF32 or cuDNN switch, deterministic
    algorithms turned on or off."""
    net = _net()
    imgs, size, net_hw = _clips(0, 2, CPU_IMG), CPU_IMG, CPU_NET_HW
    before = _key(net, imgs, size, net_hw)
    if change == "shape":
        imgs = _clips(0, 3, CPU_IMG)
    elif change == "dtype":
        imgs = imgs.double()
    elif change == "image_size":
        size = CPU_IMG * 2
    elif change == "net_hw":
        net_hw = (64, 128)
    elif change == "parameter":
        net.conv1x.weight = torch.nn.Parameter(net.conv1x.weight.detach().clone(),
                                               requires_grad=False)
    elif change == "matmul tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    elif change == "cudnn tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                            not torch.backends.cudnn.allow_tf32)
    elif change == "cudnn enabled":
        monkeypatch.setattr(torch.backends.cudnn, "enabled", not torch.backends.cudnn.enabled)
    else:
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(not was)
        try:
            assert _key(net, imgs, size, net_hw) != before
        finally:
            torch.use_deterministic_algorithms(was)
        return
    assert _key(net, imgs, size, net_hw) != before


def test_graph_key_holds_through_in_place_weight_load():
    """Other clips of the same shape, and another state dict loaded in place
    (load_state_dict copies into the tensors the net holds), keep the key."""
    net = _net()
    before = _key(net, _clips(0, 2, CPU_IMG), CPU_IMG, CPU_NET_HW)
    net.load_state_dict(tmfn.init_params(torch.Generator().manual_seed(1)))
    assert _key(net, _clips(1, 2, CPU_IMG), CPU_IMG, CPU_NET_HW) == before


def test_read_tensors_cover_the_net(cpu_net):
    """Every parameter and buffer of the net, stage 1's included."""
    got = {id(t) for t in graphs.read_tensors(cpu_net)}
    assert {id(t) for t in cpu_net.parameters()} <= got
    assert {id(t) for t in cpu_net.buffers()} <= got
    assert {id(t) for t in cpu_net.MaskFlownet_S.parameters()} <= got


@pytest.mark.parametrize("traced", [False, True])
def test_cpu_flows_equal_clip_flows(cpu_net, traced):
    """On the CPU make_flow_fn's flows are clip_flows' bit for bit, each call
    counts flow.eager_calls and nothing else (no capture, no replay, no
    kernel launch), with or without a profiler, and no graph is kept for
    the net."""
    flow_fn = tinfer.make_flow_fn(cpu_net, CPU_IMG, CPU_NET_HW)
    batches = [{"img": _clips(s, 2, CPU_IMG)} for s in range(2)]
    launches = _counters(CORR)
    before = _counters()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            got = [flow_fn(b)["optical_flows"] for b in batches]
    else:
        got = [flow_fn(b)["optical_flows"] for b in batches]
    assert _delta(before) == {"flow.graph_captures": 0, "flow.graph_replays": 0,
                              "flow.eager_calls": 2}
    assert _counters(CORR) == launches
    for b, g in zip(batches, got):
        want = tinfer.clip_flows(cpu_net, b["img"], CPU_IMG, CPU_NET_HW)
        assert g.shape == (2, 2, CPU_IMG, CPU_IMG, 2)
        assert torch.equal(g, want)
    assert id(cpu_net) not in graphs._GRAPHS


def test_numpy_clips_run_eagerly(cpu_net):
    """Clips that are not a tensor (a host array) run the eager pass."""
    imgs = _clips(3, 1, CPU_IMG)
    before = _counters()
    got = tinfer.make_flow_fn(cpu_net, CPU_IMG, CPU_NET_HW)({"img": imgs.numpy()})
    assert _delta(before)["flow.eager_calls"] == 1
    assert torch.equal(got["optical_flows"],
                       tinfer.clip_flows(cpu_net, imgs, CPU_IMG, CPU_NET_HW))


# ------------------------------------------------------------------- card --

B, IMG, NET_HW = 8, 256, (tinfer.NET_H, tinfer.NET_W)  # the multiframe trainer's flow pass


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def _eager(net, imgs) -> torch.Tensor:
    return tinfer.clip_flows(net, imgs, IMG, NET_HW)


def _flow_fn(net):
    return tinfer.make_flow_fn(net, IMG, NET_HW)


@pytest.mark.cuda
def test_replay_equals_eager(cuda_device):
    """Over distinct clips: one capture, then replays, each equal to the
    eager pass bit for bit; captures 1 and replays n - 1 over n calls."""
    net = _net(cuda_device)
    flow_fn = _flow_fn(net)
    n = 4
    before = _counters()
    for s in range(n):
        imgs = _clips(s, B, IMG, cuda_device)
        got = flow_fn({"img": imgs})["optical_flows"]
        assert torch.equal(got, _eager(net, imgs)), f"call {s}"
    # the eager reference passes count no graph counter: they bypass make_flow_fn
    assert _delta(before) == {"flow.graph_captures": 1, "flow.graph_replays": n - 1,
                              "flow.eager_calls": 0}


@pytest.mark.cuda
def test_flows_survive_later_calls(cuda_device):
    """A returned flow is the caller's: two later replays leave it alone."""
    net = _net(cuda_device)
    flow_fn = _flow_fn(net)
    kept = flow_fn({"img": _clips(0, B, IMG, cuda_device)})["optical_flows"]
    snap = kept.clone()
    for s in (1, 2):
        flow_fn({"img": _clips(s, B, IMG, cuda_device)})
    torch.cuda.synchronize()
    assert torch.equal(kept, snap)


@pytest.mark.cuda
def test_capture_beside_a_thread_on_the_default_stream(cuda_device):
    """The capture runs while another thread launches kernels, allocates,
    frees and reads results back on the default stream (as the trainer's
    loop may beside its prefetch thread): the capture succeeds, its replay
    equals the eager pass, and the other thread's results are right. (No
    thread may synchronize the whole device during a capture: CUDA forbids
    that while any stream captures.)"""
    net = _net(cuda_device)
    flow_fn = _flow_fn(net)
    a = torch.randn(512, 512, device=cuda_device)
    stop, started, bad, done = threading.Event(), threading.Event(), [], []

    def loop():
        try:
            want = a @ a
            while not stop.is_set():
                x = a.clone()  # an allocation and a kernel
                y = x @ x
                started.set()
                if not torch.equal(y, want):
                    bad.append(len(done))
                done.append(1)
        except BaseException as e:  # noqa: BLE001 - reported below
            bad.append(e)
            started.set()

    t = threading.Thread(target=loop)
    t.start()
    try:
        assert started.wait(60)
        imgs = _clips(5, B, IMG, cuda_device)
        before = _counters()
        got = flow_fn({"img": imgs})["optical_flows"]
        again = flow_fn({"img": imgs})["optical_flows"]
        n_during = len(done)
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
    assert not bad, bad
    assert n_during > 0
    assert _delta(before) == {"flow.graph_captures": 1, "flow.graph_replays": 1,
                              "flow.eager_calls": 0}
    want_flow = _eager(net, imgs)
    assert torch.equal(got, want_flow)
    assert torch.equal(again, want_flow)


@pytest.mark.cuda
def test_tracing_on_without_a_graph_runs_eagerly(cuda_device):
    """The first call under a profiler runs eagerly and captures nothing;
    once a graph exists, a call under a profiler replays it, and the
    replay's cost volumes appear in the trace."""
    net = _net(cuda_device)
    flow_fn = _flow_fn(net)
    imgs = _clips(6, B, IMG, cuda_device)
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced_eager = flow_fn({"img": imgs})["optical_flows"]
    assert _delta(before) == {"flow.graph_captures": 0, "flow.graph_replays": 0,
                              "flow.eager_calls": 1}
    flow_fn({"img": imgs})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_replay = flow_fn({"img": imgs})["optical_flows"]
        torch.cuda.synchronize()
    assert _delta(before) == {"flow.graph_captures": 1, "flow.graph_replays": 1,
                              "flow.eager_calls": 1}
    want = _eager(net, imgs)
    assert torch.equal(traced_eager, want)
    assert torch.equal(traced_replay, want)
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("corr_" in k for k in device)
    assert any(e.name == "acfm.flow.graph_replay" for e in prof.events())


@pytest.mark.cuda
def test_launch_counters_count_the_kernels_that_ran(cuda_device):
    """The cost volume's launch counters count the kernels that ran, 5 md=4
    and 10 md=2 a pass, as the eager pass launches them: the capturing call
    WARMUP_RUNS + 1 passes (its warm-up runs and the replay; the capture,
    during which no kernel runs, takes its own back), each replay one."""
    net = _net(cuda_device)
    flow_fn = _flow_fn(net)
    imgs = _clips(7, B, IMG, cuda_device)
    before = _counters(CORR)
    _eager(net, imgs)
    assert _delta(before) == {"launch.corr_md4": 5, "launch.corr_md2": 10}
    for n, passes in ((1, graphs.WARMUP_RUNS + 1), (2, 1), (3, 1)):
        before = _counters(CORR)
        flow_fn({"img": imgs})
        assert _delta(before) == {"launch.corr_md4": 5 * passes,
                                  "launch.corr_md2": 10 * passes}, f"call {n}"


@pytest.mark.cuda
def test_in_place_weight_load_keeps_the_graph(cuda_device):
    """Weights loaded in place keep the graph, and its replay computes with
    them; a replaced parameter makes a new capture."""
    net = _net(cuda_device)
    flow_fn = _flow_fn(net)
    imgs = _clips(8, B, IMG, cuda_device)
    old = flow_fn({"img": imgs})["optical_flows"]
    before = _counters()
    net.load_state_dict(tmfn.init_params(torch.Generator().manual_seed(1)))
    got = flow_fn({"img": imgs})["optical_flows"]
    assert _delta(before) == {"flow.graph_captures": 0, "flow.graph_replays": 1,
                              "flow.eager_calls": 0}
    assert torch.equal(got, _eager(net, imgs))
    assert not torch.equal(got, old)
    net.conv1x.weight = torch.nn.Parameter(net.conv1x.weight.detach() * 1.01,
                                           requires_grad=False)
    got = flow_fn({"img": imgs})["optical_flows"]
    assert _delta(before)["flow.graph_captures"] == 1
    assert torch.equal(got, _eager(net, imgs))
    assert len(graphs._GRAPHS[id(net)]) == 1
