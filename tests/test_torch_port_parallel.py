"""Data parallelism of the port (parallel/mesh.py) on the CPU.

Four gloo ranks in spawned processes (parallel/ranks.py, a file:// store
under tmp_path, one CPU thread a rank, every collective with a timeout)
against one process on the whole batch, at tests/test_multichip.py::
tiny_setup's shapes (64^2, T = 2, G = 2, optimize_deform, B = 4: one clip
a rank) with every loss weight of the multiframe step on (texture and
LPIPS, keypoints, the flow term on seeded flows): the camera-embedding
init, a warm-up step, a train step at k = G and one at k = 1, whose top-k
reads the previous step's global write-back, on a batch whose frames
repeat across ranks, then the fallback (a batch of 2 clips, which W does
not divide); one monocular train step at 64^2; the multiframe CLI's train.
Each step is held from the one process's state before it, at the
tolerances of tests/test_multichip.py (params, BatchNorm statistics, Adam
moments and the multiplex tables at rtol 1e-4 / atol 1e-5, probs at rtol
1e-3), beside the one process's own floor (parallel/checks.py has the
rules). The ranks agree bit for bit. The ranks run while the parent
records the reference.

The one-process port equals JAX through the other parity tests, and
tests/test_multichip.py shows that JAX's mesh equals JAX on one device, so
no JAX mesh is compiled here.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import shutil

import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu_torch import config as cfg_lib
from acfm_video_3d_reconstruction_tpu_torch import graft_entry as ge
from acfm_video_3d_reconstruction_tpu_torch.models.mesh_net import MeshNet
from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
from acfm_video_3d_reconstruction_tpu_torch.parallel import checks
from acfm_video_3d_reconstruction_tpu_torch.parallel import mesh as pmesh
from acfm_video_3d_reconstruction_tpu_torch.parallel.ranks import Ranks
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as mono
from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf
from tools.tigdog_fixture import write_tigdog_tree

W = 4
IMG, T, G, LBS, KPS = 64, 2, 2, 6, 3  # tiny_setup's shapes, with keypoints
B = 4          # clips of the multiframe and monocular cases (1 a rank)
B_ODD = 2      # the fallback case: W does not divide it
TIMEOUT_S = 240.0
PARENT_THREADS = 4      # the reference's CPU threads, beside the ranks' one each
FLOOR_THREADS = (2, 3)  # the floors: the reference's step on these many threads
CASES = ("multiframe", "monocular")


def mf_modules(batch_size: int, device) -> mf.MFModules:
    template = build_template(subdivide=1, num_lbs=LBS, tex_size=2, num_kps=KPS)
    cfg = cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=IMG, nz_feat=16, num_lbs=LBS, num_kps=KPS,
            tex_size=2, texture=True, symmetric=False, symmetric_texture=False),
        multiplex=dataclasses.replace(cfg_lib.MultiplexConfig(), num_guesses=G,
                                      optimize_deform=True),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=batch_size, num_frames=T,
                                  offset_z=0.0),
        mf_weights=dataclasses.replace(cfg_lib.MultiframeLossWeights(), kp=1.0),
    )
    return mf.build(cfg, template, batch_size * T * 2, seed=0, device=device)


def mf_batch(batch_size: int, seed: int, frames_idx=None) -> dict:
    """A global multiframe batch (numpy): random images, masks, keypoints,
    mirror flags, distance transforms, boundaries and flows."""
    rng = np.random.default_rng(seed)
    H, n = IMG, batch_size * T
    kp = rng.uniform(-1, 1, (batch_size, T, KPS, 3)).astype(np.float32)
    kp[..., 2] = rng.random((batch_size, T, KPS)) > 0.3
    return {
        "img": rng.random((batch_size, T, H, H, 3), np.float32),
        "mask": (rng.random((batch_size, T, H, H)) > 0.5).astype(np.float32),
        "kp": kp,
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32),
                            (batch_size, T, 1)),
        "frames_idx": (np.arange(n, dtype=np.int32).reshape(batch_size, T)
                       if frames_idx is None else frames_idx),
        "mirror_flag": rng.integers(0, 2, (batch_size, T)).astype(np.int32),
        "transforms": np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (batch_size, T, 1)),
        "optical_flows": (2.0 * rng.standard_normal((batch_size, T, H, H, 2))).astype(np.float32),
        "edt": rng.random((n, H, H)).astype(np.float32),
        "bdt": rng.random((n, H, H)).astype(np.float32),
        "boundaries": rng.random((n, 16, 3)).astype(np.float32),
    }


def repeated_frames(batch_size: int) -> np.ndarray:
    """Frame ids whose frames repeat across clips of different ranks (one
    clip a rank at B = 4): frame 1 in clips 0, 2 and 3, frame 9 twice within
    clip 1."""
    f = np.arange(batch_size * T, dtype=np.int32).reshape(batch_size, T) + 3
    f[0, 1] = f[2, 0] = f[3, 1] = 1
    f[1] = 9
    return f


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _logged(run, logs: dict, name: str):
    """run, with the mesh module's log records kept in logs[name]."""
    def wrapped():
        rec = _Records()
        pmesh.logger.addHandler(rec)
        try:
            return run()
        finally:
            pmesh.logger.removeHandler(rec)
            logs[name] = rec.messages
    return wrapped


def _with_lpips(mods) -> torch.nn.Module:
    """The model and the frozen LPIPS net as one module: the state the ranks
    load from the reference covers both."""
    return torch.nn.ModuleDict({"net": mods.model, "lpips": mods.lpips})


@contextlib.contextmanager
def _no_init():
    """The builds skip the initialisers: a rank loads the reference's
    initial state over every weight before its first step."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(MeshNet, "init_weights", lambda self, gen: None)
        for module in (mf, mono):
            m.setattr(module, "init_weights", lambda module, gen: None)
        yield


def program(case: str, device) -> checks.Program:
    """One case's modules and steps, each step on this process's block.
    The multiframe case ends with the fallback: a train step on B_ODD
    clips, which every rank runs whole."""
    seen = {}
    if case == "monocular":
        mods, _, _ = ge._build_small(batch=B, device=device)
        step = mono.make_train_step(mods)
        batch = ge._fake_batch(np.random.default_rng(1), B, 64, 4)
        steps = [("train", lambda: step(pmesh.shard_batch(batch)))]
        prog = checks.Program(_with_lpips(mods), {"opt": step.opt}, steps)
    else:
        mods = mf_modules(B, device)
        batches = [mf_batch(B, 1), mf_batch(B, 2), mf_batch(B, 3, repeated_frames(B)),
                   mf_batch(B_ODD, 4)]

        def put(b):
            return mf.to_device_batch(mods, pmesh.shard_batch(b))

        def k1():  # top-k reads the previous step's write-back
            metrics = mf.make_train_step(mods, k=1, drop_deform=False)(put(batches[2]))
            seen["probs"] = mods.mpx.probs.detach().clone()
            return metrics

        steps = [("init_camera_emb", lambda: mf.init_camera_emb(mods, put(batches[0])) or {}),
                 ("warm-up", lambda: mf.make_warmup_step(mods)(put(batches[0]))),
                 ("train k=G", lambda: mf.make_train_step(mods, k=G, drop_deform=False)(
                     put(batches[1]))),
                 ("train k=1", k1),
                 ("fallback", lambda: mf.make_train_step(mods, k=G, drop_deform=False)(
                     put(batches[3])))]
        prog = checks.Program(_with_lpips(mods), {"opt": mods.opt, "warm_opt": mods.warm_opt},
                              steps, mpx=mods.mpx, mods=mods)
    prog.logs, prog.seen = {}, seen
    prog.steps = [(name, _logged(run, prog.logs, name)) for name, run in prog.steps]
    return prog


def record_one_process(work: str) -> torch.Tensor:
    """Every case on the whole batch, no group, each step from the state
    before it, with its floors (FLOOR_THREADS; each step runs them first).
    Returns the multiframe case's probability table after its k = 1 step."""
    floors = [lambda n=n: checks.cpu_threads(n) for n in FLOOR_THREADS]
    for case in CASES:
        prog = program(case, "cpu")
        checks.record_reference(prog, work, case, floors)
        if case == "multiframe":
            probs = prog.seen["probs"]
    return probs


# the multiframe CLI's train as users run it, small: the fixture tree of
# tests/test_torch_port_multiframe_cli.py, one warm-up rep and one epoch
CLI_ARGS = ["--name", "dp", "--img_size", "64", "--num_lbs", "6", "--subdivide", "1",
            "--nz_feat", "32", "--num_guesses", "2", "--batch_size", "2",
            "--num_training_frames", "1", "--log_every", "1", "--save_epoch_freq", "1",
            "--num_epochs", "1", "--warmup", "--num_reps", "1", "--init_camera_emb",
            "--texture=False", "--of_loss_wt", "0", "--device", "cpu"]


def run_cli(work: str, run: str) -> dict:
    """cli/multiframe_main.py's train on the tree under `work`, into
    `work`/`run`; under a group every rank joins it and trains on its block
    of each batch. Returns a digest of the trained state and its step."""
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main

    o = vars(multiframe_main.parse(CLI_ARGS + [
        "--root_dir", f"{work}/tree", "--tmp_dir", f"{work}/{run}/cache",
        "--checkpoint_dir", f"{work}/{run}/snap"]))
    mods = multiframe_main.train(o)
    prog = checks.Program(mods.model, {"opt": mods.opt, "warm_opt": mods.warm_opt}, [],
                          mpx=mods.mpx, mods=mods)
    return {"digest": checks.digest(prog.state()), "step": mods.step}


def _records(work: str, run: str) -> list:
    with open(f"{work}/{run}/snap/dp/metrics.jsonl") as fh:
        return [json.loads(line) for line in fh if line.strip()]


def rank_cases(device, work: str) -> dict:
    """What every rank runs: each case, step by step from the reference's
    states (checks.run_rank), with the mesh module's log records; then the
    multiframe CLI's train."""
    out = {}
    for case in CASES:
        with _no_init():
            prog = program(case, device)
        out[case] = {"steps": checks.run_rank(prog, work, case), "logs": prog.logs,
                     "probs": prog.seen.get("probs")}
    out["cli"] = run_cli(work, "ranks")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("parallel"))
    write_tigdog_tree(f"{work}/tree", "horse", n_videos=2, n_frames=6, raw=(120, 200), seed=0)
    ranks = Ranks(rank_cases, ["cpu"] * W, "gloo", args=(work,), workdir=f"{work}/ranks",
                  timeout_s=TIMEOUT_S).start()
    try:
        with checks.cpu_threads(PARENT_THREADS):
            probs = record_one_process(work)
            cli = run_cli(work, "single")
            cli["records"] = _records(work, "single")
    finally:
        multi = ranks.join()
    cli["records_ranks"] = _records(work, "ranks")
    cli["files_ranks"] = sorted(os.listdir(f"{work}/ranks/snap/dp"))
    cli["files_single"] = sorted(os.listdir(f"{work}/single/snap/dp"))
    shutil.rmtree(work, ignore_errors=True)
    return probs, multi, cli


def _steps(multi, r, case):
    """Rank r's steps of a case; "fallback" is the multiframe program's
    last step."""
    steps = multi[r]["monocular" if case == "monocular" else "multiframe"]["steps"]
    return [s for s in steps if (s["step"] == "fallback") == (case == "fallback")]


@pytest.mark.parametrize("case", ["multiframe", "monocular", "fallback"])
def test_ranks_equal_one_process_on_the_whole_batch(runs, case):
    """Every step of rank 0 from the one process's state before it, held by
    parallel/checks.py::judge; the ranks' states identical bit for bit."""
    _, multi, _ = runs
    for per_rank in zip(*(_steps(multi, r, case) for r in range(W))):
        step, rep = per_rank[0], checks.merge([s["report"] for s in per_rank])
        print(case, step["step"], "undecided", rep["undecided"], "of", rep["decided"],
              "(floor", rep["floor_undecided"], ") held to the floor:", len(rep["floor_held"]),
              "worst", max(rep["floor_held"], key=lambda x: x[1] / x[2], default=None))
        assert not rep["fails"], (step["step"], rep["fails"])
        assert rep["undecided_ok"], (step["step"], rep["undecided"], rep["decided"])
    for per_rank in zip(*(_steps(multi, r, case) for r in range(W))):
        assert len({s["digest"] for s in per_rank}) == 1, per_rank[0]["step"]


def test_every_rank_took_the_fallback_with_a_warning(runs):
    """The fallback step warns on every rank; no other step does."""
    _, multi, _ = runs
    for r in range(W):
        for case in CASES:
            for name, messages in multi[r][case]["logs"].items():
                warned = any("shard fallback" in m for m in messages)
                assert warned == (name == "fallback"), (r, case, name)


def test_repeated_frames_take_their_last_occurrence(runs):
    """A frame shared by clips on different ranks holds the row of its last
    occurrence in (B, T) order over the global batch (the write-back of the
    k = 1 step, where every selected row is 1 and the others 0)."""
    single, multi, _ = runs
    f = repeated_frames(B).reshape(-1)
    for probs in [single] + [m["multiframe"]["probs"] for m in multi]:
        for frame in (1, 9):
            assert torch.equal(probs[frame].sort().values, torch.tensor([0.0, 1.0]))
    for r in range(W):
        torch.testing.assert_close(multi[r]["multiframe"]["probs"][f], single[f], rtol=0, atol=0)


def test_multiframe_cli_on_two_ranks_and_one_process(runs):
    """The training CLI's train under the group of W ranks and in one
    process: the ranks end bit-identical after the same number of steps;
    rank 0 alone wrote the log and the checkpoints (the same files as one
    process's); the first warm-up record (one step from the same state)
    within the tolerances of one process's, every record finite."""
    _, multi, cli = runs
    assert len({m["cli"]["digest"] for m in multi}) == 1
    assert {m["cli"]["step"] for m in multi} == {cli["step"]}
    assert cli["files_ranks"] == cli["files_single"]
    recs, single = cli["records_ranks"], cli["records"]
    assert [sorted(r) for r in recs] == [sorted(r) for r in single]
    assert [r["step"] for r in recs] == [r["step"] for r in single]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    np.testing.assert_allclose(recs[0]["warmup_loss"], single[0]["warmup_loss"],
                               rtol=checks.RTOL, atol=checks.ATOL)


def test_shard_batch_blocks_and_fallback(caplog):
    batch = mf_batch(2 * W, 0)  # two clips a rank
    for r in range(W):
        part = pmesh.shard_batch(batch, world=W, rank_=r)
        assert np.array_equal(part["frames_idx"], batch["frames_idx"][2 * r:2 * r + 2])
        assert np.array_equal(part["edt"], batch["edt"][2 * r * T:(2 * r + 2) * T])
        assert np.array_equal(part["boundaries"],
                              batch["boundaries"][2 * r * T:(2 * r + 2) * T])
    odd = mf_batch(B_ODD, 0)
    with caplog.at_level(logging.WARNING, logger=pmesh.logger.name):
        same = pmesh.shard_batch(odd, world=W, rank_=1)
    assert same is odd
    assert "shard fallback" in caplog.text and "'img'" in caplog.text
    assert pmesh.shard_batch(batch, world=1, rank_=0) is batch


def test_without_a_group_nothing_is_reduced(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not pmesh.active() and pmesh.world_size() == 1 and pmesh.is_main()
    assert pmesh.init_from_env("cpu") == torch.device("cpu") and not pmesh.active()
    x = torch.arange(6.0).reshape(3, 2)
    assert pmesh.gather_rows(x) is x and pmesh.shard_batch({"a": x}) == {"a": x}
    m = {"a": torch.tensor(1.5)}
    assert pmesh.reduce_metrics(m) is m


def test_buckets_keep_order_and_limit():
    ts = [torch.zeros(3), torch.zeros(5), torch.zeros(2, dtype=torch.float64), torch.zeros(9),
          torch.zeros(1)]
    got = [[t.numel() for t in b] for b in pmesh._buckets(ts, 8)]
    assert got == [[3, 5], [2], [9], [1]]


def test_entry_on_the_cpu():
    """graft_entry.entry at __graft_entry__.py's shapes: the same numpy
    batch, a finite loss from the monocular forward."""
    import __graft_entry__ as jge

    fn, (mods, batch) = ge.entry("cpu")
    ref = jge._fake_batch(np.random.default_rng(0), 2, 64, 4)
    for k, v in ref.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), err_msg=k)
    loss, metrics = fn(mods, batch)
    assert loss.shape == () and math.isfinite(float(loss))
    assert set(metrics) >= {"kp_loss", "mask_loss", "tex_loss", "total_loss"}


def test_dryrun_multichip_two_gloo_ranks(capsys):
    loss = ge.dryrun_multichip(2, "cpu", timeout_s=TIMEOUT_S)
    assert f"dryrun_multichip(2) ok: total_loss={loss:.4f}" in capsys.readouterr().out
    np.testing.assert_allclose(loss, ge.dryrun_step("cpu", 2), rtol=checks.RTOL)


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        ge.dryrun_multichip(2, "cuda")
