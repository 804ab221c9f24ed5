"""The multiframe training step replayed as one CUDA graph
(train/multiframe.py::make_train_step through utils/graphs.py's training
case).

Two step shapes at 64^2 (icosphere subdivide 1, 6 handles, G = 4
hypotheses, 2 clips of 2 frames, texture and the flow loss on): k = G
with quaternion cameras, and k = 2 < G with az-el cameras and the
per-frame deformation tables. Both sides start from one build (one seed).

On the CPU a stand-in takes the place of the captured graph ("captures"
nothing, "replays" the step on the static inputs), so the step's way
through graphs.run is held without a card: the first call eager, the
second captures and replays, N steps through that path equal N eager
steps bit for bit (no extra update), and the counters. On the card: N
steps through the graph equal N eager steps bit for bit in parameters,
buffers, Adam's moments and counts, the multiplex tables and the metrics,
also while another thread replays the flow pass's graph; a replay under
tracing counts the views and the device counters as an eager step does.
Both sides run with deterministic algorithms, and with the bilinear
upsampling of LPIPS and of the texture decoder as interpolation matrices
(`exact_bilinear_upsampling`): CUDA's backward of that upsampling adds
with atomics, so two eager steps would differ from each other at rounding
level.

This file imports neither JAX nor the JAX package, so the card's tests run
on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_train_graph.py
"""
import contextlib
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.flow import infer as tinfer
from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as tmfn
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.parallel import mesh as tmesh
from acfm_video_3d_reconstruction_tpu_torch.train import driver as tdriver
from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as tmf
from acfm_video_3d_reconstruction_tpu_torch.utils import graphs, tracing

torch.set_num_threads(1)

IMG, G, B, T, N_FRAMES, STEPS = 64, 4, 2, 2, 8, 4
TEMPLATE = dict(subdivide=1, num_lbs=6, tex_size=2, num_kps=0)
# (multiplex options, k)
SHAPES = {"quat_k_eq_G": ({}, G),
          "az_el_deform_k_lt_G": (dict(az_el_cam=True, optimize_deform=True), 2)}
TRAIN = ("train.graph_captures", "train.graph_replays", "train.eager_calls")
FRAMES = (((0, 1), (2, 3)), ((4, 5), (6, 7)), ((1, 2), (5, 6)), ((0, 3), (4, 7)))


def _cfg(mp: dict) -> tcfg.Config:
    return tcfg.Config(
        model=dataclasses.replace(
            tcfg.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=0, tex_size=2,
            subdivide=1, texture=True, symmetric=False, symmetric_texture=False),
        multiplex=dataclasses.replace(tcfg.MultiplexConfig(), num_guesses=G, **mp),
        train=dataclasses.replace(tcfg.TrainConfig(), batch_size=B, num_frames=T,
                                  offset_z=0.0, use_gtpose=False),
        mf_weights=dataclasses.replace(tcfg.MultiframeLossWeights(), kp=0.0),
    )


def _batch(seed: int, frames) -> dict:
    """A clip batch: textured images over disc masks that move between the
    frames, a smooth flow field, random cameras, one clip mirrored, an
    active affine transform."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:IMG, :IMG] / IMG * 2 - 1
    img = rng.random((B, T, IMG, IMG, 3)).astype(np.float32) * 0.3
    mask = np.zeros((B, T, IMG, IMG), np.float32)
    for b in range(B):
        cx, cy, r = rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(0.4, 0.6)
        for t in range(T):
            mask[b, t] = ((xx - cx - 0.05 * t) ** 2 + (yy - cy) ** 2 <= r * r)
            img[b, t] += mask[b, t, ..., None] * rng.uniform(0.3, 0.7, 3)
    flow = np.stack([1.5 + np.sin(2 * xx + 1) + 0.5 * yy, -0.5 + np.cos(3 * yy) * 0.8], -1)
    flows = np.zeros((B, T, IMG, IMG, 2), np.float32)
    flows[:, :-1] = flow
    q = rng.normal(size=(B, T, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([rng.uniform(0.6, 0.9, (B, T, 1)), rng.uniform(-0.1, 0.1, (B, T, 2)),
                            q], -1).astype(np.float32)
    transforms = np.tile(np.asarray([1.02, 0.04, -0.03, 1.0], np.float32), (B, T, 1))
    transforms[0, :, 3] = 0.0
    bounds = rng.uniform(-0.8, 0.8, (B * T, 40, 3)).astype(np.float32)
    bounds[..., 2] = (rng.random((B * T, 40)) > 0.2)
    return {
        "img": np.clip(img, 0, 1), "mask": mask,
        "kp": np.zeros((B, T, 3, 3), np.float32), "sfm_pose": poses,
        "frames_idx": np.asarray(frames, np.int32),
        "mirror_flag": np.asarray([[0, 0], [1, 1]], np.int32), "transforms": transforms,
        "edt": rng.random((B * T, IMG, IMG)).astype(np.float32),
        "boundaries": bounds, "optical_flows": flows,
    }


def _build(shape: str, device) -> tuple:
    """(modules, k, the device batches of STEPS steps): one seed, so two
    builds start from one state; the hypotheses' probabilities drawn, so
    that top-k keeps different hypotheses per frame."""
    mp, k = SHAPES[shape]
    mods = tmf.build(_cfg(mp), ttemplate.build_template(**TEMPLATE), N_FRAMES, seed=3,
                     device=device)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(5)
        mods.mpx.probs.copy_(torch.rand(mods.mpx.probs.shape, generator=gen))
    batches = [tmf.to_device_batch(mods, _batch(10 + i, f)) for i, f in enumerate(FRAMES)]
    return mods, k, batches


def _state(mods) -> dict:
    """Every tensor a step changes, by name: the modules' parameters and
    buffers (the multiplex tables among them) and Adam's state."""
    out = {}
    for prefix, net in (("model", mods.model), ("mpx", mods.mpx)):
        for name, t in net.state_dict().items():
            out[f"{prefix}.{name}"] = t.detach().clone()
    names = {id(p): n for n, p in list(mods.model.named_parameters())
             + [(f"mpx.{n}", p) for n, p in mods.mpx.named_parameters()]}
    for p, st in mods.opt.state.items():
        for key, t in st.items():
            out[f"adam.{names[id(p)]}.{key}"] = t.detach().clone()
    return out


def _run(mods, k, batches) -> list:
    step = tmf.make_train_step(mods, k=k, drop_deform=True)
    return [{n: v.clone() for n, v in step(b).items()} for b in batches]


def _eager_only():
    """graphs.run as the eager call, for the reference side."""
    return _patched(graphs, "run", lambda name, owner, device, signature, eager, **_: eager())


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _mismatches(got_state, want_state, got_metrics, want_metrics) -> list:
    bad = [n for n, t in want_state.items() if not torch.equal(got_state[n], t)]
    bad += [f"step {i} {n}" for i, (g, w) in enumerate(zip(got_metrics, want_metrics))
            for n in w if not torch.equal(g[n], w[n])]
    return bad + sorted(set(got_state) ^ set(want_state))


def _counters(names=TRAIN) -> dict:
    c = tracing.counters()
    return {n: c.get(n, 0) for n in names}


# -------------------------------------------------------------------- CPU --

class _StandIn:
    """graphs._Graph without CUDA: "captures" nothing and "replays" fn on
    the static inputs."""

    def __init__(self, fn, inputs, read, device, train=False):
        assert train, "the train step captures as the training case"
        self.fn, self.inputs, self.read = fn, inputs, read

    def replay(self, op):
        assert op == "acfm.train.graph_replay"
        return self.fn(self.inputs)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_steps_through_the_graph_path_equal_eager_steps(monkeypatch, shape):
    """The step's way through graphs.run on CUDA, with a stand-in graph on
    CPU tensors: the first call eager (the warm-up is a real step), the
    second captures and replays, the rest replay; no call adds an update,
    so STEPS steps equal STEPS eager steps bit for bit in every parameter,
    buffer, table and Adam state, and in the metrics."""
    ref, k, batches = _build(shape, "cpu")
    with _eager_only():
        want = _run(ref, k, batches)
    mods, _, _ = _build(shape, "cpu")
    monkeypatch.setattr(graphs, "_Graph", _StandIn)
    mods.device = torch.device("cuda")  # the graph path, on CPU tensors
    before = _counters()
    got = _run(mods, k, batches)
    assert {n: v - before[n] for n, v in _counters().items()} == {
        "train.graph_captures": 1, "train.graph_replays": STEPS - 2, "train.eager_calls": 1}
    assert not _mismatches(_state(mods), _state(ref), got, want)
    assert mods.step == ref.step == STEPS


def test_a_process_group_keeps_every_call_eager(monkeypatch, tmp_path):
    """Under a process group (a gloo world of one) every step runs eagerly
    outside utils/graphs.py, on the graph path's device too: graphs.run is
    never called, no `train.*` counter moves, and the steps equal the
    eager steps of a run without a group."""
    ref, k, batches = _build("quat_k_eq_G", "cpu")
    with _eager_only():
        want = _run(ref, k, batches[:2])
    mods, _, _ = _build("quat_k_eq_G", "cpu")
    mods.device = torch.device("cuda")  # the graph path, on CPU tensors

    def unused(*args, **kw):
        raise AssertionError("graphs.run was called under a process group")

    monkeypatch.setattr(graphs, "run", unused)
    before = _counters()
    tmesh.init("gloo", f"file://{tmp_path}/store", 1, 0)
    try:
        got = _run(mods, k, batches[:2])
    finally:
        tmesh.shutdown()
    assert _counters() == before
    ref_state, state = _state(ref), _state(mods)
    assert not _mismatches(state, ref_state, got, want)


def _driver_cfg(tmp_path) -> tcfg.Config:
    """_cfg's model on the main loop alone: one epoch, vis_fn every step,
    no mid-run save."""
    cfg = _cfg({})
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=1, display_freq=1, save_epoch_freq=1000,
        checkpoint_dir=str(tmp_path), name="t"))


def _loader(n: int) -> list:
    return [_batch(10 + i, FRAMES[i % len(FRAMES)]) for i in range(n)]


def test_the_flow_pass_and_vis_fn_never_run_at_once(monkeypatch, tmp_path):
    """train/driver.py runs flow_fn on the prefetch thread and never while
    the loop is in vis_fn (which may start or stop a profiler): with a
    step that takes no time and a flow_fn and a vis_fn of 50 ms each, the
    two would overlap on every step without that rule."""
    monkeypatch.setattr(tmf, "make_train_step", lambda mods, **kw: lambda batch: {})
    spans = {"flow": [], "vis": []}
    threads = set()

    def timed(name, seconds=0.05):
        t0 = time.perf_counter()
        time.sleep(seconds)
        spans[name].append((t0, time.perf_counter()))

    def flow_fn(batch):
        threads.add(threading.current_thread().name)
        timed("flow")
        return batch

    tdriver.run_multiframe_training(
        _driver_cfg(tmp_path), ttemplate.build_template(**TEMPLATE), _loader(8), None,
        N_FRAMES, flow_fn=flow_fn, vis_fn=lambda save_dir, step, batch: timed("vis"),
        device="cpu")
    assert threads == {"acfm-prefetch"}
    assert len(spans["flow"]) == len(spans["vis"]) == 8
    assert not [(f, v) for f in spans["flow"] for v in spans["vis"]
                if f[0] < v[1] and v[0] < f[1]]


# ------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _upsampling_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of bilinear interpolation along one axis with
    align_corners False, as F.interpolate computes them; made once per
    shape (in the eager warm-up step: a capture may not copy from the
    host)."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5).clamp(min=0)
    lo = src.floor().long().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    w = src - lo
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m[torch.arange(n_out), lo] += 1 - w
    m[torch.arange(n_out), hi] += w
    return m.float().to(device)


@contextlib.contextmanager
def exact_bilinear_upsampling():
    """Bilinear upsampling (LPIPS's, the texture decoder's) as two matmuls
    with interpolation matrices (a deterministic backward) within the
    block."""
    real = F.interpolate

    def interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=None):
        if mode != "bilinear" or align_corners:
            return real(x, size=size, scale_factor=scale_factor, mode=mode,
                        align_corners=align_corners)
        if size is None:
            size = (x.shape[-2] * scale_factor, x.shape[-1] * scale_factor)
        rows = _upsampling_matrix(size[0], x.shape[-2], x.device)
        cols = _upsampling_matrix(size[1], x.shape[-1], x.device)
        return rows @ x @ cols.T

    with _patched(F, "interpolate", interpolate):
        yield


@contextlib.contextmanager
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with exact_bilinear_upsampling():
            yield
    finally:
        torch.use_deterministic_algorithms(was)


def _flow_thread(device, stop: threading.Event, calls: list):
    """Another thread that, as the trainer's prefetch thread does, uploads
    clips through pinned memory and replays the flow pass's graph on them,
    on its default stream, until `stop`."""
    net = tmfn.build(tmfn.init_params(torch.Generator().manual_seed(0)), device)
    flow_fn = tinfer.make_flow_fn(net, IMG, (64, 128))
    host = torch.rand((B, T, IMG, IMG, 3), generator=torch.Generator().manual_seed(1))
    flow_fn({"img": host.to(device)})  # its capture, before the trainer starts

    def work():
        done = torch.cuda.Event()
        while not stop.is_set():
            flow_fn({"img": host.pin_memory().to(device, non_blocking=True)})
            calls.append(1)
            done.record()
            done.synchronize()

    return threading.Thread(target=work, name="acfm-prefetch", daemon=True)


@pytest.mark.cuda
@pytest.mark.parametrize("beside", ["alone", "beside_a_flow_graph"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_replayed_steps_equal_eager_steps(cuda_device, shape, beside):
    """STEPS steps through the graph (one eager warm-up, a capture replayed
    at once, then replays) equal STEPS eager steps from the same build, bit
    for bit, in parameters, buffers, the multiplex tables, Adam's moments
    and counts, and the metrics; also while another thread replays the flow
    pass's graph on its own stream through the capture."""
    with deterministic():
        ref, k, batches = _build(shape, cuda_device)
        with _eager_only():
            want = _run(ref, k, batches)
        mods, _, _ = _build(shape, cuda_device)
        stop, calls, thread = threading.Event(), [], None
        if beside != "alone":
            thread = _flow_thread(cuda_device, stop, calls)
            thread.start()
        before = _counters()
        try:
            got = _run(mods, k, batches)
            torch.cuda.synchronize(cuda_device)
        finally:
            stop.set()
            if thread is not None:
                thread.join()
    assert {n: v - before[n] for n, v in _counters().items()} == {
        "train.graph_captures": 1, "train.graph_replays": STEPS - 2, "train.eager_calls": 1}
    if thread is not None:
        assert calls, "the flow thread replayed nothing"
    assert not _mismatches(_state(mods), _state(ref), got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_a_traced_replay_counts_as_an_eager_step(cuda_device, shape):
    """Under a profiler a replay adds the views its capture decoded (k x B
    x T) and the device counts `solve.failures` and `raster.faces_dropped`,
    as a traced eager step of the same batch counts them; no span of the
    step is recorded in a replay."""
    mods, k, batches = _build(shape, cuda_device)
    step = tmf.make_train_step(mods, k=k, drop_deform=True)
    step(batches[0])
    step(batches[1])  # the capture
    names = ("multiplex.views", "solve.failures", "raster.faces_dropped")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step(batches[2])
    replay = {n: tracing.counters().get(n) for n in names}
    assert not [s for s in tracing.record() if s.name.startswith("train.")]
    with _eager_only():
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            step(batches[2])
        eager = {n: tracing.counters().get(n) for n in names}
    assert replay == eager
    assert replay["multiplex.views"] == k * B * T


@pytest.mark.cuda
def test_a_profiler_stops_beside_the_prefetch_threads_flow_replays(cuda_device, tmp_path):
    """The trainer's loop as the benchmark drives it: the flow pass's graph
    replayed on the prefetch thread, the step's graph on the loop's thread,
    and a vis_fn that starts a torch profiler over every thread and stops
    it again, three times. Every stop returns (a stop that met a graph
    launch in flight on the prefetch thread could deadlock both threads),
    and the steps after the first two replay."""
    net = tmfn.build(tmfn.init_params(torch.Generator().manual_seed(0)), cuda_device)
    flow_fn = tinfer.make_flow_fn(net, IMG, (64, 128))
    from torch._C._profiler import _ExperimentalConfig

    prof, stops = [], []

    def vis_fn(save_dir, step, batch):
        if step in (2, 4, 6):
            prof.append(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                experimental_config=_ExperimentalConfig(
                                    profile_all_threads=True)))
            prof[-1].start()
        elif step in (3, 5, 7):
            prof[-1].stop()
            stops.append(step)

    before, failure = _counters(), []

    def loop():
        try:
            tdriver.run_multiframe_training(
                _driver_cfg(tmp_path), ttemplate.build_template(**TEMPLATE), _loader(8), None,
                N_FRAMES, flow_fn=flow_fn, vis_fn=vis_fn, device=cuda_device)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            failure.append(e)

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    thread.join(300)
    assert not thread.is_alive(), f"the loop hung; profiler stops that returned: {stops}"
    if failure:
        raise failure[0]
    assert stops == [3, 5, 7]
    assert {n: v - before[n] for n, v in _counters().items()} == {
        "train.graph_captures": 1, "train.graph_replays": 6, "train.eager_calls": 1}
