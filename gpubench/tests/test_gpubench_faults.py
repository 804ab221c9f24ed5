"""A run whose timed path is broken underneath comes out not correct. Each
test skips the harness's look for a card and drives the rest of a run (the
cell at a small size on the CPU, held to the cell's own limits) with one
fault planted in the program: a step that leaves its state unchanged, half
of the batch left out (the mean over the rest), an answer altered where it
is produced. One chip has no exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from gpubench import run as R

from .small import CPU, no_native, small_cell

SEED = 2 ** 31 + 11


def run_broken(name, monkeypatch):
    no_native(monkeypatch)
    result, checks = R.run_cell(small_cell(name), SEED, 1.0, False, CPU)
    return result, {k: v for k, (v, _) in checks.items()}


def unchanged(make):
    """A step factory whose steps compute their metrics and leave every
    parameter and the optimizer's state as they were."""

    def factory(mods, *a, **kw):
        step = make(mods, *a, **kw)
        opt = getattr(step, "opt", None) or mods.opt

        def broken(batch):
            params = [p for g in opt.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            metrics = step(batch)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            opt.state.clear()
            return metrics

        broken.opt = opt
        return broken

    return factory


def half_batch(make, clip_keys=None):
    """A step factory whose steps take the first half of the batch only."""

    def factory(mods, *a, **kw):
        step = make(mods, *a, **kw)

        def broken(batch):
            B = len(batch["img"])
            return step({k: v[: (B // 2) * (len(v) // B)] for k, v in batch.items()})

        broken.opt = getattr(step, "opt", None)
        return broken

    return factory


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_multiframe_training_fault(fault, monkeypatch):
    from acfm_video_3d_reconstruction_tpu_torch.flow import infer
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    if fault == "unchanged":
        monkeypatch.setattr(mf, "make_train_step", unchanged(mf.make_train_step))
    elif fault == "half_batch":
        monkeypatch.setattr(mf, "make_train_step", half_batch(mf.make_train_step))
    else:  # the flows altered where the flow layer makes them
        clip_flows = infer.clip_flows
        monkeypatch.setattr(infer, "clip_flows", lambda *a, **k: clip_flows(*a, **k) * 1.01)
    result, numbers = run_broken("mf-train", monkeypatch)
    assert not result["correct"], numbers


@pytest.mark.parametrize("fault", ["verts_altered", "mask_altered"])
def test_predict_fault(fault, monkeypatch):
    """At one image a request there is no half of a batch to leave out."""
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor

    predict = predictor.predict_monocular

    def broken(mods, batch):
        out = predict(mods, batch)
        if fault == "verts_altered":
            out = dict(out, verts=out["verts"] * 1.01)
        else:  # half of the mask's columns left out
            mask = out["mask_pred"].clone()
            mask[..., mask.shape[-1] // 2:] = 0
            out = dict(out, mask_pred=mask)
        return out

    monkeypatch.setattr(predictor, "predict_monocular", broken)
    result, numbers = run_broken("mono-predict", monkeypatch)
    assert not result["correct"], numbers
