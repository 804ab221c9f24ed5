#!/usr/bin/env python3
"""Where the TTO refiner's kernels-vs-plain difference comes from, on one GPU.

    python3 tools/torch_tto_drift.py [--iters 100] [--forced 0,1,...]
        [--out chiprun_out/tto_drift.json]

Runs chip_smoke.py's build and multiframe phases (the horse model at the
multiframe CLI's defaults, 4 warm-up and 4 train steps on the TigDog
fixture), then the evaluate CLI's runs a (test split, the predicted camera)
and b (train split, the argmax-multiplex camera, the camera optimized) with
TTO, keeping every batch's refiner inputs (its flows are the kernel path's,
so every run below sees the same flow targets). For each input, under
deterministic algorithms, --iters iterations of the refiner:

  kernels  the kernel path, the reference of every row;
  again    the kernel path once more (its run-to-run floor);
  plain    the plain rasterizer (rasterizer_cuda.forward_plain /
           backward_plain on the card);
  ulp      the kernel path from the input's delta_v_res with every entry
           moved by one ulp, up or down by a seeded coin: the trajectory's
           own response to one f32 rounding of its input;
  forced   at each of the kernel path's iterations in --forced, one
           iteration from that state through the plain path and one through
           the kernels: the kernels' own difference there, without the
           trajectory's.

Per iteration and run, against the kernel path's iteration: the vector
relative error of the state (delta_v_res and, camera optimized, the raw
camera) and of its gradient, the soft mask's largest difference, the
pixels whose soft pix_to_face differs, and the discrete choices of the loss
that differ: vertices whose soft visibility (the boundary term's) or hard
visibility (the flow term's) flips, valid boundary points whose nearest
visible vertex (the boundary term's amin) is another, vertices whose flow
sample (grid_sample, nearest) lands on another pixel. After the free runs,
pred_v's and the final loss's relative errors. Writes the records as JSON
to --out and prints a summary per input.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def _rel(torch, a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    diff = torch.linalg.vector_norm(a - b).item()
    return 0.0 if diff == 0 else diff / max(torch.linalg.vector_norm(b).item(), 1e-300)


@contextlib.contextmanager
def recording(torch, rec):
    """Within the block every refiner iteration appends to `rec` its
    parameters before the step and their gradients (chip_smoke.tto_params),
    the soft pass's mask, pix_to_face and visibility, the hard visibility,
    the flow term's sample pixels and the boundary term's nearest visible
    vertices."""
    from acfm_video_3d_reconstruction_tpu_torch.losses import losses as L
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras

    real_soft, real_hard, real_bds = (ras.soft_silhouette_vis, ras.hard_visibility,
                                      L.boundaries_loss)

    def soft(verts, faces, *a, **kw):
        mask, p2f, vis = real_soft(verts, faces, *a, **kw)
        rec["mask"].append(mask.detach().clone())
        rec["p2f"].append(p2f.clone())
        rec["vis"].append(vis.detach().clone())
        return mask, p2f, vis

    def hard(verts, faces, image_size, *a, **kw):
        vis = real_hard(verts, faces, image_size, *a, **kw)
        rec["hard"].append(vis.clone())
        # grid_sample(nearest, align_corners=False)'s pixel of each vertex
        rec["pix"].append(torch.floor((verts[..., :2].detach() + 1) * image_size / 2).long())
        return vis

    def bds(proj_verts, boundaries, vis_verts, *a, **kw):
        # the boundary term's nearest visible vertex of each valid point
        d2 = torch.cdist(boundaries[..., :2], proj_verts.detach()) ** 2
        d2 = torch.where(vis_verts[:, None, :] > 0, d2, torch.full_like(d2, float("inf")))
        rec["nn"].append(torch.where(boundaries[..., 2] > 0, d2.argmin(-1), -1))
        return real_bds(proj_verts, boundaries, vis_verts, *a, **kw)

    ras.soft_silhouette_vis, ras.hard_visibility, L.boundaries_loss = soft, hard, bds
    try:
        with cs.tto_params(torch, rec):
            yield
    finally:
        ras.soft_silhouette_vis, ras.hard_visibility, L.boundaries_loss = (
            real_soft, real_hard, real_bds)


def _new_rec():
    return {k: [] for k in ("state", "grad", "mask", "p2f", "vis", "hard", "pix", "nn")}


def _compare(torch, rec, ref, i, j=None):
    """Iteration j of `rec` against iteration i of the reference."""
    j = i if j is None else j
    out = {"state": _rel(torch, rec["state"][j], ref["state"][i]),
           "grad": _rel(torch, rec["grad"][j], ref["grad"][i]),
           "mask_max": (rec["mask"][j] - ref["mask"][i]).abs().max().item(),
           "p2f_pixels": int((rec["p2f"][j] != ref["p2f"][i]).sum()),
           "vis_flips": int((rec["vis"][j] != ref["vis"][i]).sum()),
           "nn_switches": int((rec["nn"][j] != ref["nn"][i]).sum())}
    if ref["hard"]:
        out["hard_flips"] = int((rec["hard"][j] != ref["hard"][i]).sum())
        out["pix_moves"] = int((rec["pix"][j] != ref["pix"][i]).any(-1).sum())
    return out


def analyse(torch, inp, n, forced_at):
    """The four runs of one refiner input (module docstring), free runs of n
    iterations, forced at the kernel path's iterations `forced_at`; inp
    holds mods, tto, nf (frames per clip), tag and args (the refiner's)."""
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor

    mean_shape, lbs, delta, cam, batch = inp["args"]

    def refine(num_iter, d, c, plain):
        rec = _new_rec()
        fn = predictor.make_tto_step_fn(
            inp["mods"], dataclasses.replace(inp["tto"], num_iter=num_iter), inp["nf"])
        with contextlib.ExitStack() as stack:
            stack.enter_context(cs.deterministic_algorithms(torch))
            if plain:
                stack.enter_context(cs.plain_rasterizer())
            stack.enter_context(recording(torch, rec))
            pred_v, _, final = fn(mean_shape, lbs, d, c, batch)
        if pred_v.is_cuda:
            torch.cuda.synchronize()
        return rec, pred_v, final

    # one ulp up or down, by a seeded coin per entry
    gen = torch.Generator(device=delta.device).manual_seed(0)
    coin = torch.rand(delta.shape, generator=gen, device=delta.device) < 0.5
    away = torch.where(coin, float("inf"), float("-inf")).to(delta.dtype)
    ref, pv_k, fl_k = refine(n, delta, cam, False)
    free = {"again": refine(n, delta, cam, False), "plain": refine(n, delta, cam, True),
            "ulp": refine(n, torch.nextafter(delta, away), cam, False)}
    runs = {name: [_compare(torch, r[0], ref, i) for i in range(n)] for name, r in free.items()}
    after = {name: {"pred_v": _rel(torch, r[1], pv_k), "final_loss": _rel(torch, r[2], fl_k)}
             for name, r in free.items()}
    n_delta = delta.numel()
    forced = []
    for i in forced_at:
        d_i = ref["state"][i][:n_delta].reshape(delta.shape)
        c_i = ref["state"][i][n_delta:].reshape(cam.shape) if inp["tto"].optimize_camera else cam
        fk, pk, lk = refine(1, d_i, c_i, False)
        fp, pp, lp = refine(1, d_i, c_i, True)
        row = _compare(torch, fp, fk, 0)
        row.update(iteration=i, same_as_trajectory=_rel(torch, fk["grad"][0], ref["grad"][i]),
                   pred_v_after_step=_rel(torch, pp, pk), loss_after_step=_rel(torch, lp, lk))
        forced.append(row)
    return {"run": inp["tag"], "camera_optimized": inp["tto"].optimize_camera, "iters": n,
            "after": after, "runs": runs, "forced": forced}


EVENTS = ("vis_flips", "nn_switches", "hard_flips", "pix_moves")


def summary(row) -> str:
    def first(rows, test):
        return next((i for i, r in enumerate(rows) if test(r)), None)

    runs, forced = row["runs"], row["forced"]
    per_run = {name: {"after": {k: f"{v:.3g}" for k, v in row["after"][name].items()},
                      "state_over_1e-4": first(rows, lambda r: r["state"] > 1e-4),
                      "first_event": first(rows, lambda r: any(r.get(k) for k in EVENTS)),
                      "state_at": [f"{rows[i]['state']:.2g}" for i in (1, 3, 5, 10, 20, 50)
                                   if i < len(rows)]}
               for name, rows in runs.items()}
    worst = {k: f"{max(r[k] for r in forced):.3g}"
             for k in ("grad", "pred_v_after_step", "loss_after_step", "mask_max")}
    worst.update({k: sum(r.get(k) or 0 for r in forced) for k in EVENTS})
    return (f"run {row['run']}: {json.dumps(per_run)}; forced at {len(forced)} iterations, "
            f"worst {json.dumps(worst)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--forced", default="0,1,2,3,4,5,6,7,8,9,19,29,39,49,59,69,79,89,99",
                    help="the kernel path's iterations at which the forced run compares")
    ap.add_argument("--out", default="chiprun_out/tto_drift.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_tto_drift: no CUDA device available", file=sys.stderr)
        return 1
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as mfe
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        mf_out = cs.phase_multiframe(torch, device, "", tmp)
        base = mfe.default_opts()
        base.update({k: v for k, v in mf_out["opts"].items() if k in base or k == "flow_net_hw"})
        base.update(num_optim_iter=1, device=str(device))
        real_make = predictor.make_tto_step_fn
        inputs = []

        def keep(mods, tto, num_frames, trace_vert2kp=None):
            def run(mean_shape, lbs, delta, cam, batch):
                inputs.append(dict(tag=tag, mods=mods, tto=tto, nf=num_frames,
                                   args=(mean_shape, lbs, delta.detach().clone(),
                                         cam.detach().clone(), dict(batch))))
                return real_make(mods, tto, num_frames)(mean_shape, lbs, delta, cam, batch)
            return run

        for tag, flags in (("a", dict(split="test", optimize=True)),
                           ("b", dict(split="train", use_argmax_camera=True, optimize=True,
                                      optimize_camera=True))):
            predictor.make_tto_step_fn = keep
            try:
                mfe.evaluate(dict(base, results_dir=os.path.join(tmp, f"eval_{tag}"), **flags))
            finally:
                predictor.make_tto_step_fn = real_make

        for k, inp in enumerate(inputs):
            t0 = time.perf_counter()
            forced_at = [int(i) for i in args.forced.split(",") if int(i) < args.iters]
            row = analyse(torch, inp, args.iters, forced_at)
            results.append(dict(row, input=k))
            print(f"[drift] input {k} ({time.perf_counter() - t0:.1f} s): {summary(row)}",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
