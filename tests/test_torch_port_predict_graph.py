"""predict_monocular's forward replayed as a CUDA graph
(eval/predict_graph.py through utils/graphs.py).

On the CPU: the signature a graph is kept under (`graph_signature` in
graphs.graph_key), the counters of eager calls, and predict_monocular
against make_eval_step bit for bit. On the card, at the monocular CLI's
configuration on CUB-format requests: replay against the eager forward bit
for bit, outputs that later calls leave alone, an in-place weight reload,
a replaced parameter, the counters, and the replay's kernels in a profile.

This file imports neither JAX nor the JAX package, so the card's tests run
on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_predict_graph.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.eval import predict_graph as pg
from acfm_video_3d_reconstruction_tpu_torch.eval import predictor
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono
from acfm_video_3d_reconstruction_tpu_torch.utils import graphs, tracing

torch.set_num_threads(1)

IMG, N_BOUNDS = 64, 40
OUT_KEYS = {"verts": "pred_v", "cam_pred": "cam_pred", "kp_pred": "kp_pred",
            "mask_pred": "mask_pred"}
PREDICT_COUNTERS = ("predict.graph_captures", "predict.graph_replays", "predict.eager_calls")


def _cfg(**model):
    return tcfg.Config(
        model=dataclasses.replace(
            tcfg.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=4, tex_size=2,
            texture=True, symmetric=False, symmetric_texture=False, **model),
        train=dataclasses.replace(tcfg.TrainConfig(), batch_size=1),
    )


@pytest.fixture(scope="module")
def cpu_mods():
    return tmono.build(_cfg(), ttemplate.build_template(subdivide=2, num_lbs=6, tex_size=2,
                                                         num_kps=4), seed=0, device="cpu")


def _batch(seed: int, n_bounds: int = N_BOUNDS, dtype=np.float32) -> dict:
    """A B = 1 request's arrays, as add_mask_geometry(collate(...)) gives them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:IMG, :IMG] / IMG * 2 - 1
    q = rng.normal(size=(1, 4))
    q /= np.linalg.norm(q)
    return {
        "img": rng.random((1, IMG, IMG, 3)).astype(dtype),
        "mask": (xx ** 2 + yy ** 2 <= rng.uniform(0.2, 0.4))[None].astype(np.float32),
        "kp": np.concatenate([rng.uniform(-0.8, 0.8, (1, 4, 2)), np.ones((1, 4, 1))],
                             -1).astype(np.float32),
        "sfm_pose": np.concatenate([[[0.8, 0.0, 0.0]], q], -1).astype(np.float32),
        "edt": rng.random((1, IMG, IMG)).astype(np.float32),
        "boundaries": rng.uniform(-0.8, 0.8, (1, n_bounds, 3)).astype(np.float32),
    }


def _predict_counters() -> dict:
    c = tracing.counters()
    return {k: c.get(k, 0) for k in PREDICT_COUNTERS}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _predict_counters().items()}


# -------------------------------------------------------------------- CPU --

def _key(mods, batch) -> tuple:
    return graphs.graph_key(*pg.graph_signature(mods, batch))


def _read(mods) -> list:
    return pg.graph_signature(mods, _batch(0))[1]


def _replace_parameter(mods):
    mods.model.mean_v = torch.nn.Parameter(mods.model.mean_v.detach().clone())


def _replace_buffer(mods):
    bn = next(m for m in mods.model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    bn.running_mean = bn.running_mean.clone()


def _replace_lpips_parameter(mods):
    conv = next(m for m in mods.lpips.modules() if isinstance(m, torch.nn.Conv2d))
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())


@pytest.mark.parametrize("change", [
    "shape", "dtype", "parameter", "buffer", "lpips parameter", "matmul tf32", "cudnn tf32",
    "cudnn enabled", "deterministic", "autocast dtype"])
def test_graph_key_changes(cpu_mods, monkeypatch, change):
    """A new key for another batch shape or dtype, a replaced parameter or
    buffer of the model or LPIPS, a flipped TF32 or cuDNN switch,
    deterministic algorithms turned on or off, another autocast dtype."""
    mods = copy.deepcopy(cpu_mods)
    batch = _batch(0)
    before = _key(mods, batch)
    if change == "shape":
        batch = _batch(0, n_bounds=N_BOUNDS + 1)
    elif change == "dtype":
        batch = _batch(0, dtype=np.float64)
    elif change == "parameter":
        _replace_parameter(mods)
    elif change == "buffer":
        _replace_buffer(mods)
    elif change == "lpips parameter":
        _replace_lpips_parameter(mods)
    elif change == "matmul tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    elif change == "cudnn tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                            not torch.backends.cudnn.allow_tf32)
    elif change == "cudnn enabled":
        monkeypatch.setattr(torch.backends.cudnn, "enabled", not torch.backends.cudnn.enabled)
    elif change == "deterministic":
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(not was)
        try:
            assert _key(mods, batch) != before
        finally:
            torch.use_deterministic_algorithms(was)
        return
    else:
        mods.cfg = _cfg(dtype="bfloat16")
    assert _key(mods, batch) != before


def test_graph_key_holds_through_in_place_weight_load(cpu_mods):
    """Another request of the same shapes, and new values copied into every
    parameter and buffer in place (as a weight load does), keep the key."""
    mods = copy.deepcopy(cpu_mods)
    before = _key(mods, _batch(0))
    with torch.no_grad():
        for t in _read(mods):
            if t.is_floating_point():
                t.copy_(t * 0.5 + 0.25)
    assert _key(mods, _batch(1)) == before


def test_read_tensors_cover_the_modules(cpu_mods):
    """Every parameter and buffer of the model and of LPIPS, and the faces,
    edges and Laplacian."""
    got = {id(t) for t in _read(cpu_mods)}
    for net in (cpu_mods.model, cpu_mods.lpips):
        assert {id(t) for t in net.parameters()} <= got
        assert {id(t) for t in net.buffers()} <= got
    assert {id(cpu_mods.faces), id(cpu_mods.edges), id(cpu_mods.lap)} <= got


def test_static_inputs_lie_apart_and_aligned():
    """The static inputs are views of one buffer, one per batch key, each at
    a 512-byte boundary, none overlapping the next."""
    shapes = {k: tuple(v.shape) for k, v in _batch(0).items()}
    flat = torch.zeros(sum(pg._padded(int(np.prod(s))) for s in shapes.values()))
    views = pg._views(flat, shapes)
    assert {k: tuple(v.shape) for k, v in views.items()} == shapes
    starts = sorted((v.data_ptr() - flat.data_ptr(), v.numel() * 4) for v in views.values())
    assert all(at % 512 == 0 for at, _ in starts)
    assert all(a + n <= b for (a, n), (b, _) in zip(starts, starts[1:]))
    assert starts[-1][0] + starts[-1][1] <= flat.numel() * 4


@pytest.mark.parametrize("traced", [False, True])
def test_cpu_calls_count_as_eager(cpu_mods, traced):
    """Every CPU call runs eagerly and counts predict.eager_calls, with or
    without a profiler: no capture, no replay, no kernel launch."""
    launches = {k: v for k, v in tracing.counters().items() if k.startswith("launch.")}
    before = _predict_counters()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            for s in range(2):
                predictor.predict_monocular(cpu_mods, _batch(s))
    else:
        for s in range(2):
            predictor.predict_monocular(cpu_mods, _batch(s))
    assert _delta(before) == {"predict.graph_captures": 0, "predict.graph_replays": 0,
                              "predict.eager_calls": 2}
    assert {k: v for k, v in tracing.counters().items() if k.startswith("launch.")} == launches


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_predict_equals_eval_step(cpu_mods, seed):
    """predict_monocular's vertices, camera, keypoints and mask are
    make_eval_step's, bit for bit, and its lbs and mean shape the model's."""
    batch = _batch(seed)
    want = tmono.make_eval_step(cpu_mods)(batch)
    got = predictor.predict_monocular(cpu_mods, batch)
    for k, w in OUT_KEYS.items():
        assert torch.equal(got[k], want[w]), k
    assert torch.equal(got["lbs"], cpu_mods.model.get_lbs())
    assert torch.equal(got["mean_shape"], cpu_mods.model.get_mean_shape())


# ------------------------------------------------------------------- card --

N_REQUESTS = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cub_cell(tmp_path_factory):
    """The monocular CLI's configuration with --num_lbs 16 (the benchmark's
    acfm-monocular-cub) and N_REQUESTS test-split requests of a CUB-format
    tree, as add_mask_geometry(collate(...)) gives them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    from acfm_video_3d_reconstruction_tpu_torch.cli import monocular_main as cli
    from acfm_video_3d_reconstruction_tpu_torch.data.cub import CUBDataset
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import add_mask_geometry, collate
    from tools.cub_fixture import write_cub_tree

    root = str(tmp_path_factory.mktemp("cub"))
    write_cub_tree(root, n_train=2, n_test=N_REQUESTS, raw=(300, 400), seed=7)
    args = cli.parse(["--num_lbs", "16", "--cub_dir", root, "--cub_cache_dir", root])
    cfg = cli.build_cfg(args)
    template = cli.build_cub_template(cfg, args)
    ds = CUBDataset(root, root, split="test", img_size=args.img_size, mirror=False)
    requests = [add_mask_geometry(collate([ds[i]])) for i in range(len(ds))]
    assert len(requests) == N_REQUESTS
    return cfg, template, requests


def _cuda_mods(cub_cell, seed=0):
    cfg, template, _ = cub_cell
    return tmono.build(cfg, template, seed=seed, device="cuda")


def _eager(mods, batch) -> dict:
    aux = tmono.make_eval_step(mods)(batch)
    return {k: aux[w] for k, w in OUT_KEYS.items()}


def _assert_equal(got: dict, want: dict, what: str):
    for k in OUT_KEYS:
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


@pytest.mark.cuda
def test_replay_equals_eager(cuda_device, cub_cell):
    """Over N_REQUESTS distinct requests: one capture, then replays, each
    equal to the eager forward bit for bit; the kernels' launch counters
    count the kernels that ran."""
    mods = _cuda_mods(cub_cell)
    before = _predict_counters()
    launches = tracing.counters()
    for n, batch in enumerate(cub_cell[2]):
        _assert_equal(predictor.predict_monocular(mods, batch), _eager(mods, batch),
                      f"request {n}")
    assert _delta(before) == {"predict.graph_captures": 1,
                              "predict.graph_replays": N_REQUESTS - 1,
                              "predict.eager_calls": 0}
    after = tracing.counters()
    # eager: N_REQUESTS; graph: N_REQUESTS replays and the capture's warm-up
    for k in ("launch.soft", "launch.hard"):
        assert after[k] - launches.get(k, 0) == 2 * N_REQUESTS + graphs.WARMUP_RUNS, k


@pytest.mark.cuda
def test_outputs_survive_later_calls(cuda_device, cub_cell):
    """A returned tensor is the caller's: later replays leave it alone."""
    mods = _cuda_mods(cub_cell)
    kept = [predictor.predict_monocular(mods, b) for b in cub_cell[2][:4]]
    snap = [{k: out[k].clone() for k in OUT_KEYS} for out in kept]
    for b in cub_cell[2][4:8]:
        predictor.predict_monocular(mods, b)
    torch.cuda.synchronize()
    for out, s in zip(kept, snap):
        _assert_equal(out, s, "kept output")


@pytest.mark.cuda
def test_in_place_weight_reload_replays_new_weights(cuda_device, cub_cell):
    """Weights copied in place (as gpubench's load_into does) keep the graph,
    and its replay computes with them."""
    mods = _cuda_mods(cub_cell)
    other = _cuda_mods(cub_cell, seed=1)
    batch = cub_cell[2][0]
    old = predictor.predict_monocular(mods, batch)
    before = _predict_counters()
    with torch.no_grad():
        for net, src in ((mods.model, other.model), (mods.lpips, other.lpips)):
            params = dict(src.named_parameters())
            for name, p in net.named_parameters():
                p.copy_(params[name])
    got = predictor.predict_monocular(mods, batch)
    assert _delta(before) == {"predict.graph_captures": 0, "predict.graph_replays": 1,
                              "predict.eager_calls": 0}
    _assert_equal(got, _eager(mods, batch), "after the reload")
    assert not torch.equal(got["verts"], old["verts"])


@pytest.mark.cuda
def test_replaced_parameter_recaptures(cuda_device, cub_cell):
    """A parameter replaced by another tensor makes a new capture, whose
    replay equals the eager forward."""
    mods = _cuda_mods(cub_cell)
    batch = cub_cell[2][1]
    predictor.predict_monocular(mods, batch)
    mods.model.mean_v = torch.nn.Parameter(mods.model.mean_v.detach() * 1.01)
    before = _predict_counters()
    got = predictor.predict_monocular(mods, batch)
    again = predictor.predict_monocular(mods, batch)
    assert _delta(before) == {"predict.graph_captures": 1, "predict.graph_replays": 1,
                              "predict.eager_calls": 0}
    want = _eager(mods, batch)
    _assert_equal(got, want, "recaptured")
    _assert_equal(again, want, "replayed")


@pytest.mark.cuda
def test_tensor_batches_replay_equal_eager(cuda_device, cub_cell):
    """A batch of CUDA tensors has a signature of its own, and its replays
    equal the eager forward."""
    mods = _cuda_mods(cub_cell)
    before = _predict_counters()
    for batch in cub_cell[2][:3]:
        batch = {k: torch.as_tensor(batch[k], device=cuda_device) for k in tmono.BATCH_KEYS}
        _assert_equal(predictor.predict_monocular(mods, batch), _eager(mods, batch), "tensors")
    assert _delta(before) == {"predict.graph_captures": 1, "predict.graph_replays": 2,
                              "predict.eager_calls": 0}


@pytest.mark.cuda
def test_tracing_on_without_a_graph_runs_eagerly(cuda_device, cub_cell):
    """The first call under a profiler runs eagerly and captures nothing;
    once a graph exists, a call under a profiler replays it."""
    mods = _cuda_mods(cub_cell)
    batch = cub_cell[2][2]
    before = _predict_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        predictor.predict_monocular(mods, batch)
    assert _delta(before)["predict.eager_calls"] == 1
    assert _delta(before)["predict.graph_captures"] == 0
    predictor.predict_monocular(mods, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _assert_equal(predictor.predict_monocular(mods, batch), _eager(mods, batch), "traced")
    assert _delta(before) == {"predict.graph_captures": 1, "predict.graph_replays": 1,
                              "predict.eager_calls": 1}


def _kernels_inside(prof, name: str) -> list:
    """The kernels of the host ops inside the range `name` on its thread,
    as gpubench/harness/trace.py sums a span's device time."""
    events = prof.events()
    (outer,) = [e for e in events if e.name == name]
    out, stack = [], [outer]
    while stack:
        node = stack.pop()
        if node.thread == outer.thread:
            out.extend(k.name for k in node.kernels)
        stack.extend(node.cpu_children)
    return out


@pytest.mark.cuda
def test_replay_kernels_appear_in_the_profile(cuda_device, cub_cell):
    """Under torch.profiler a replay's rasterizer kernels, soft and hard,
    appear by name in the trace, tied to a host op inside the enclosing
    record_function: what the benchmark's device time of a span reads."""
    mods = _cuda_mods(cub_cell)
    batch = cub_cell[2][3]
    predictor.predict_monocular(mods, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("test.predict"):
            predictor.predict_monocular(mods, batch)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    inside = _kernels_inside(prof, "test.predict")
    for kernel in ("raster_fwd_kernel<true>", "raster_fwd_kernel<false>"):
        assert any(kernel in k for k in device), kernel
        assert any(kernel in k for k in inside), kernel
    # the replay's other kernels are tied there too: more than the copies
    assert len(inside) > 100
