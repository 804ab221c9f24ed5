"""The port's spans and counters (utils/tracing.py) on the CPU.

Off (no profiler) a span enters no record_function and nothing is kept.
Under a CPU torch.profiler that records every thread, a few multiframe
train steps fed through prefetch.prefetch (flow from make_flow_fn with the
net's pass stubbed) and one request of the monocular prediction path put
every span into the record and into the profiler's events as acfm.*, on
its thread, with its parent, self time and unit. The device counters count
the bin pass's dropped faces and the solve's failed factors; the kernels'
launches are host counters.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.data import cub as tcub
from acfm_video_3d_reconstruction_tpu_torch.data import loader as tloader
from acfm_video_3d_reconstruction_tpu_torch.deform import solve
from acfm_video_3d_reconstruction_tpu_torch.eval import predictor
from acfm_video_3d_reconstruction_tpu_torch.flow import infer as tinfer
from acfm_video_3d_reconstruction_tpu_torch.geometry import camera, icosphere
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono
from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as tmf
from acfm_video_3d_reconstruction_tpu_torch.train import prefetch
from acfm_video_3d_reconstruction_tpu_torch.utils import tracing
from tools.cub_fixture import write_cub_tree

torch.set_num_threads(1)

IMG, G, B, T, N_FRAMES, STEPS = 64, 2, 2, 2, 8, 3
LOOP = {"train.forward", "train.backward", "train.optimizer"}
# inside train.forward and train.optimizer
MULTIPLEX = {"multiplex.select": "train.forward", "multiplex.writeback": "train.optimizer"}
PREFETCH = {"data.load", "data.upload", "flow.infer"}
REQUEST = {"data.decode", "data.crop", "data.mask_geometry", "predict"}


def cpu_profiler():
    """A CPU torch.profiler recording every thread where the installed
    torch can (as the benchmark's traced run does); (profiler, all threads?)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return profile(activities=[ProfilerActivity.CPU]), False
    return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg), True


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _small_scene():
    v, f = icosphere.icosphere(2)
    proj = camera.orthographic_proj_withz(
        torch.tensor(v, dtype=torch.float32)[None] * 0.7,
        torch.tensor([[0.9, 0.05, -0.05, 1.0, 0.0, 0.0, 0.0]]), offset_z=5.0)
    return proj, torch.tensor(f)


def _mf_cfg():
    return tcfg.Config(
        model=dataclasses.replace(
            tcfg.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=0, tex_size=2,
            subdivide=1, texture=True, symmetric=False, symmetric_texture=False),
        multiplex=dataclasses.replace(tcfg.MultiplexConfig(), num_guesses=G),
        train=dataclasses.replace(tcfg.TrainConfig(), batch_size=B, num_frames=T, offset_z=0.0,
                                  use_gtpose=False),
        mf_weights=dataclasses.replace(tcfg.MultiframeLossWeights(), kp=0.0),
    )


def _mf_batch(seed: int) -> dict:
    """A clip batch of numpy arrays, as the loader gives it (no flows)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:IMG, :IMG] / IMG * 2 - 1
    mask = np.zeros((B, T, IMG, IMG), np.float32)
    for b in range(B):
        for t in range(T):
            mask[b, t] = (xx - 0.05 * t) ** 2 + yy ** 2 <= 0.25
    q = rng.normal(size=(B, T, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([rng.uniform(0.6, 0.9, (B, T, 1)), rng.uniform(-0.1, 0.1, (B, T, 2)),
                            q], -1).astype(np.float32)
    bounds = rng.uniform(-0.8, 0.8, (B * T, 40, 3)).astype(np.float32)
    return {
        "img": rng.random((B, T, IMG, IMG, 3)).astype(np.float32), "mask": mask,
        "kp": np.zeros((B, T, 3, 3), np.float32), "sfm_pose": poses,
        "frames_idx": np.asarray([[0, 1], [2, 3]], np.int32),
        "mirror_flag": np.zeros((B, T), np.int32),
        "transforms": np.tile(np.asarray([1.0, 0.0, 0.0, 1.0], np.float32), (B, T, 1)),
        "edt": rng.random((B * T, IMG, IMG)).astype(np.float32), "boundaries": bounds,
    }


@pytest.fixture(scope="module")
def cub_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    write_cub_tree(root, n_train=2, n_test=2, raw=(80, 120), seed=3)
    return root


def _mono_mods(cub_root):
    S, _ = tcub.load_sfm_mean_shape(cub_root)
    template = ttemplate.build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=15,
                                        sfm_kp_points=S)
    cfg = tcfg.Config(
        model=dataclasses.replace(
            tcfg.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=15, tex_size=2,
            subdivide=2, texture=False, symmetric=False, symmetric_texture=False),
        train=dataclasses.replace(tcfg.TrainConfig(), batch_size=1),
    )
    return tmono.build(cfg, template, device="cpu")


def test_off_enters_no_record_function_and_keeps_nothing(monkeypatch):
    """With no profiler a span reads the flag and returns: record_function
    (patched to raise) is never entered, the record and the device counters
    stay empty through the bin pass, the solve and prefetch's spans; host
    counters still count."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.on()
    with tracing.span("train.forward", 3):
        tracing.count_device("solve.failures", torch.tensor(True))
    proj, faces = _small_scene()
    th, tw = rc._pick_tiles(IMG)
    rc._face_tables(proj, faces, IMG, th, tw, 64, rc._margin(rc.BLUR_RADIUS))
    solve.screened_poisson_solve(torch.zeros(4, 3), torch.zeros(2, 4), torch.zeros(1, 2, 3),
                                 torch.zeros(4, 4))
    batches = [{"x": np.ones(2, np.float32)} for _ in range(2)]
    got = list(prefetch.prefetch(
        batches, lambda b: prefetch.to_device(b, ("x",), torch.device("cpu"))))
    assert len(got) == 2
    tracing.count("launch.soft")
    assert tracing.record() == []
    assert tracing.counters() == {"launch.soft": 1}


def test_every_span_lands_on_its_thread_under_the_profiler(monkeypatch, cub_root):
    """Steps of the CPU multiframe step fed by prefetch.prefetch (prep: the
    upload, then make_flow_fn's function with the net's pass stubbed), and
    one request of the prediction path inside a span of the test's own:
    every span of the port is in the record and in the profiler's events
    as acfm.<name>; train.* and multiplex.* (inside train.forward and
    train.optimizer) on the loop's thread with unit mods.step, data.load /
    data.upload / flow.infer on the prefetch thread, the request's spans
    on the caller's thread as children of the test's span, whose self time
    is its duration less theirs."""
    mods = tmf.build(_mf_cfg(), ttemplate.build_template(subdivide=1, num_lbs=6, tex_size=2,
                                                          num_kps=0), N_FRAMES, device="cpu")
    mono = _mono_mods(cub_root)
    ds = tcub.CUBDataset(cub_root, cub_root, split="test", img_size=IMG, jitter_frac=0.0)
    monkeypatch.setattr(tinfer, "clip_flows", lambda net, imgs, size, hw: torch.zeros(
        imgs.shape[:2] + (size, size, 2)))
    flow_fn = tinfer.make_flow_fn(None, IMG)
    step = tmf.make_train_step(mods, k=G)
    prof, all_threads = cpu_profiler()
    with prof:
        with tracing.span("test.request") as outer:
            batch = tloader.add_mask_geometry(tloader.collate([ds[0]]))
            out = predictor.predict_monocular(mono, batch)
        assert out["verts"].shape[0] == 1
        for db in prefetch.prefetch([_mf_batch(s) for s in range(STEPS)],
                                    lambda b: flow_fn(tmf.to_device_batch(mods, b))):
            step(db)
    spans = tracing.record()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == LOOP | set(MULTIPLEX) | PREFETCH | REQUEST | {"test.request"}
    main = threading.current_thread().name
    for name in LOOP | set(MULTIPLEX):
        assert [s.unit for s in by_name[name]] == list(range(STEPS))
        assert {s.thread for s in by_name[name]} == {main}
    ids = {s.id: s.name for s in spans}
    for name, parent in MULTIPLEX.items():
        assert {ids[s.parent] for s in by_name[name]} == {parent}
    for name in PREFETCH:
        assert {s.thread for s in by_name[name]} == {"acfm-prefetch"}, name
    assert len(by_name["flow.infer"]) == len(by_name["data.upload"]) == STEPS
    # the loader's end is one more next()
    assert len(by_name["data.load"]) == STEPS + 1
    own = tracing.self_ns(spans)
    (req,) = by_name["test.request"]
    kids = [s for n in REQUEST for s in by_name[n]]
    assert {s.thread for s in kids} == {main}
    assert outer.id == req.id
    assert {s.parent for s in kids} == {req.id}
    assert own[req.id] == (req.end_ns - req.start_ns) - sum(s.end_ns - s.start_ns for s in kids)
    assert all(s.start_ns >= req.start_ns and s.end_ns <= req.end_ns for s in kids)
    assert all(own[s.id] == s.end_ns - s.start_ns for s in kids)
    assert isinstance(by_name["predict"][0].unit, int)
    events = {}
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            events.setdefault(e.name[len(tracing.PREFIX):], set()).add(e.thread)
    seen = LOOP | set(MULTIPLEX) | REQUEST | {"test.request"} | (PREFETCH if all_threads
                                                                  else set())
    assert seen <= set(events)
    if all_threads:
        (loop_thread,) = events["train.forward"]
        assert events["flow.infer"] == events["data.upload"] == events["data.load"]
        assert events["flow.infer"] != {loop_thread}
    counts = tracing.counters()
    assert counts["solve.failures"] == 0
    assert counts["raster.faces_dropped"] >= 0


def test_faces_dropped_equal_bin_overflow_counts():
    """A scene whose bins overflow a capacity of 64 faces: the bin pass's
    device counter reads bin_overflow_counts' sum, at the pass's margin."""
    proj, faces = _small_scene()
    th, tw = rc._pick_tiles(IMG)
    margin = rc._margin(rc.BLUR_RADIUS)
    want = int(rc.bin_overflow_counts(proj, faces, IMG, 64, margin).sum())
    assert want > 0
    prof, _ = cpu_profiler()
    with prof:
        rc._face_tables(proj, faces, IMG, th, tw, 64, margin)
    assert tracing.counters()["raster.faces_dropped"] == want


def test_a_matrix_not_positive_definite_counts_one_solve_failure():
    """A solve of a well-posed system counts nothing; one whose normal
    matrix is zero (not positive definite) counts one failure."""
    gen = torch.Generator().manual_seed(0)
    V, K = 6, 2
    mean_v = torch.randn(V, 3, generator=gen)
    lbs = torch.softmax(torch.randn(K, V, generator=gen), 0)
    L = torch.eye(V) - torch.full((V, V), 1.0 / V)
    prof, _ = cpu_profiler()
    with prof:
        solve.screened_poisson_solve(mean_v, lbs, torch.zeros(1, K, 3), L)
        assert tracing.counters()["solve.failures"] == 0
        solve.screened_poisson_solve(mean_v, torch.zeros(K, V), torch.zeros(1, K, 3),
                                     torch.zeros(V, V))
    assert tracing.counters()["solve.failures"] == 1


def test_a_new_session_clears_the_last_once_read():
    prof, _ = cpu_profiler()
    with prof:
        with tracing.span("a"):
            pass
        tracing.count_device("n", torch.tensor([1, 2]))
    assert [s.name for s in tracing.record()] == ["a"]
    assert tracing.counters()["n"] == 3
    prof, _ = cpu_profiler()
    with prof:
        with tracing.span("b", 5):
            pass
    assert [(s.name, s.unit, s.parent) for s in tracing.record()] == [("b", 5, None)]
    assert "n" not in tracing.counters()


def test_self_ns_leaves_out_children_on_the_thread():
    S = tracing.Span
    spans = [S(1, "c", "t", 10, 20, 0, None), S(2, "d", "t", 25, 40, 0, None),
             S(0, "p", "t", 0, 100, None, 7), S(3, "q", "u", 5, 50, None, None)]
    assert tracing.self_ns(spans) == {0: 75, 1: 10, 2: 15, 3: 45}


def test_host_counters_lose_no_update_across_threads():
    """Eight threads add to one host counter with a short switch interval:
    no addition is lost."""
    n, each = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [tracing.count("x") for _ in range(each)])
                   for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tracing.counters()["x"] == n * each


def test_collect_takes_this_threads_counts_off_the_session():
    """Within collect() (a graph's capture) this thread counts with tracing
    off, into the collection and not the session: the device counts as
    tensors summed per name, the traced host counts as numbers; another
    thread and the code after the block count as before."""
    assert not tracing.counting()
    other = []
    with tracing.collect() as got:
        assert tracing.counting()
        tracing.count_device("raster.faces_dropped", torch.tensor([2, 0, 1]))
        tracing.count_device("raster.faces_dropped", torch.tensor([4]))
        tracing.count_traced("multiplex.views", 8)
        tracing.count_traced("multiplex.views", 8)
        t = threading.Thread(target=lambda: other.append(tracing.counting()))
        t.start()
        t.join()
    assert not tracing.counting() and other == [False]
    assert got.traced == {"multiplex.views": 16}
    assert {k: int(v) for k, v in got.device.items()} == {"raster.faces_dropped": 7}
    assert "raster.faces_dropped" not in tracing.counters()
    assert "multiplex.views" not in tracing.counters()
