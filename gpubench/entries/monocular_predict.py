"""Single-image prediction as users run it: the program's
eval/predictor.py::predict_monocular at B = 1, in a closed loop with one
client.

Each request is one test-split image of the configuration's data set,
drawn in an order from the seed: decoded, cropped and resized on the host
as data/cub.py does, its mask geometry made as the program's loader makes
it, then predicted; the vertices, camera, keypoints and mask come back to
the host. Its latency runs from the request's start to its outputs on the
host (host clock). The first `warm_requests` are set-up; then the window
runs request after request. A sample of the window's requests, its first
and every `sample_every`-th from an offset drawn from the seed, is kept for
the comparison with the reference.
"""
from __future__ import annotations

import time

import numpy as np

from ..harness import weights as W
from ..harness.bench import Spans, Window, WindowClosed, log, seconds_since_process_start
from ..harness.train_loop import sync_of
from ..reference import monocular as ref_mono
from ..reference.common import set_precision


def run(cell, seed: int, seconds: float, device, tmp: str, profiler=None):
    import types

    from acfm_video_3d_reconstruction_tpu_torch.cli import monocular_main as cli
    from acfm_video_3d_reconstruction_tpu_torch.data.cub import CUBDataset
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import add_mask_geometry, collate
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular as mono

    def mark(what):
        log(f"set-up: {what} at {seconds_since_process_start():.2f} s")

    mark("program imported")
    tr = cell.traffic
    a = vars(cli.parse([]))
    a.update(vars(ref_mono.options(cell)))
    args = types.SimpleNamespace(**a)
    set_precision(cell.config["precision"])
    cfg = cli.build_cfg(args)
    mods = mono.build(cfg, cli.build_cub_template(cfg, args), device=device)
    w = ref_mono.weights_of(cell, seed, device)
    W.load_into(mods.model, w["meshnet"])
    W.load_into(mods.lpips, w["lpips"])
    del w
    ds = CUBDataset(args.cub_dir, args.cub_cache_dir, split="test", img_size=args.img_size,
                    mirror=False)
    rng = np.random.default_rng(int(seed))
    order = rng.permutation(len(ds))
    offset = int(rng.integers(tr["sample_every"]))
    mark("modules built")
    spans = Spans()
    window = Window(seconds, tr["warm_requests"], sync_of(device), profiler)
    latencies, cap = [], {"indices": [], "answers": []}
    n = 0
    try:
        while True:
            i = int(order[n % len(order)])
            t0 = time.perf_counter()
            with spans.span("request"):
                with spans.span("prepare"):
                    batch = add_mask_geometry(collate([ds[i]]))
                with spans.span("predict"):
                    out = predictor.predict_monocular(mods, batch)
                answer = {k: out[k].cpu() for k in ("verts", "cam_pred", "kp_pred", "mask_pred")}
            latency = time.perf_counter() - t0
            if window.open:
                latencies.append(latency)
                k = len(latencies) - 1
                if k == 0 or k % tr["sample_every"] == offset:
                    cap["indices"].append(i)
                    cap["answers"].append(answer)
            n += 1
            window.tick()
            if window.ticks == window.warm:
                spans.reset()
    except WindowClosed:
        pass
    info = {"latencies": latencies,
            "shapes": {"img_size": args.img_size, "num_faces": int(mods.faces.shape[0]),
                       "soft_views": 1, "hard_views": 1}}
    return window, spans, cap, info


def end_to_end(window, info) -> dict:
    return {"predict_p95_ms": 1e3 * float(np.percentile(info["latencies"], 95))}


def check(cell, seed: int, device, cap, info) -> dict:
    return ref_mono.compare_predict(cell, seed, device, cap)


def control(cell, seed: int, device, kind: str) -> dict:
    return ref_mono.control_predict(cell, seed, device, kind)


def unit_flops(cell, device, info) -> float:
    return ref_mono.predict_flops(cell, device)
