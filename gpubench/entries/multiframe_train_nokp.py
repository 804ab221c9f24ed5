"""The camera-multiplex recipe for horses without keypoints as users run it:
the main loop of the program's train/driver.py::run_multiframe_training
after the first hypothesis drop.

The set-up is the multiframe CLI's `train` (cli/multiframe_main.py) with
the configuration's flags, as entries/multiframe_train.py sets up the
CLI's defaults: the scaled template (--scale_mesh), the TigDog and
YouTube-VIS video data sets mixed by the CLI's build_video_dataset
(--expand_ytvis) and their frame cache, the shuffled and augmented clip
loader, the frozen MaskFlownet as the loop's flow_fn. The loop starts at
the traffic's `start_epoch`, where the program's drop schedule keeps k of
the G az-el hypotheses; the warm-ups, the init pass and the saves are off.
The weights are the benchmark's, made on the card from the seed, and the
multiplex state a run has at that epoch is drawn from the seed and written
before the first step (reference/multiframe_nokp.py::write_multiplex). The
first `warm_steps` steps are set-up, the first `capture_steps` of them kept
for the comparison; then the window runs the loop as it is. The rate is
the frames of every step finished in the window over the window. The log
gives the window's step intervals and the host ms a step of the harness's
spans (the loop's wait for a batch, the step, the flow pass), which say
whether the loop or the prefetch thread paced the run.

`correct` also holds the run to the configuration's mix (`mix`, 0 when
held): the step's views are k·B·T at the reference's k, and the captured
batches hold a mask-only clip (every keypoint zero).
"""
from __future__ import annotations

import statistics
import time

from ..harness import train_loop as tl
from ..harness import weights as W
from ..harness.bench import Spans, Window, log, seconds_since_process_start
from ..reference import multiframe as ref_mf
from ..reference import multiframe_nokp as ref


def options(cell, tmp: str) -> dict:
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as cli

    o = cli.default_opts()
    o.update(cell.config["cli"])
    o.update(ref.mixed(cell.config["dataset"]))
    o.update(checkpoint_dir=tmp, name=cell.name, warmup=False, texture_warmup=False,
             init_camera_emb=False, save_epoch_freq=10 ** 9, save_latest_freq=0,
             display_freq=1, num_epochs=10 ** 6,
             num_pretrain_epochs=cell.traffic["start_epoch"])
    o["flow_net_hw"] = tuple(cell.config["flow_net_hw"])
    return o


def run(cell, seed: int, seconds: float, device, tmp: str, profiler=None):
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as cli
    from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as tig
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import DataLoader
    from acfm_video_3d_reconstruction_tpu_torch.flow import infer as flow_infer
    from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as mfn
    from acfm_video_3d_reconstruction_tpu_torch.train import driver
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf
    from acfm_video_3d_reconstruction_tpu_torch.train import prefetch

    def mark(what):
        log(f"set-up: {what} at {seconds_since_process_start():.2f} s")

    mark("program imported")
    tr = cell.traffic
    o = options(cell, tmp)
    ref_mf.set_precision(cell.config["precision"])
    cfg = cli.build_cfg(o)
    template = cli.build_mf_template(cfg)
    video_ds = cli.build_video_dataset(o)
    n_frames, s2v, spv = tig.explode_to_frames(video_ds, o["tmp_dir"], o["category"],
                                               o["num_training_frames"], write=False)
    mark("template and frame index")
    kw = ref_mf.dataset_kwargs(o, s2v, spv)
    dataset = tig.MultiFrameDataset(mirror=o["mirror"], transforms=tr["augment"],
                                    seed=ref_mf.data_seed(seed), **kw)
    loader = DataLoader(dataset, o["batch_size"], shuffle=tr["shuffle"],
                        seed=ref_mf.loader_seed(seed))

    def load_pretrained(model):
        mark("modules built")
        W.load_into(model, ref.weights_of(cell, seed, device, nets=("meshnet",))["meshnet"])

    def load_lpips(lpips):
        W.load_into(lpips, ref.weights_of(cell, seed, device, nets=("lpips",))["lpips"])

    net = mfn.build(ref.flow_weights(cell, seed, device), device)
    flow_inner = flow_infer.make_flow_fn(net, o["img_size"], o["flow_net_hw"])
    mark("flow net built")
    spans = Spans()
    window = Window(seconds, tr["warm_steps"], tl.sync_of(device), profiler)
    cap = tl.Capture(tr["capture_steps"])
    ks = []  # the k of every step factory the loop made (one per epoch)

    def flow_fn(batch):
        with spans.span("flow"):
            return flow_inner(batch)

    make_step = mf.make_train_step

    def make_train_step(mods, **kw):
        if not ks:
            ref.write_multiplex(mods.mpx, cell, seed)
        ks.append(kw["k"])
        step = make_step(mods, **kw)
        params = tl.named_params({"model": mods.model, "mpx": mods.mpx})

        def train_step(batch):
            cap.before(params)
            with spans.span("step"):
                metrics = step(batch)
            cap.after(batch, metrics, params, mods.opt, {"probs": mods.mpx.probs})
            return metrics

        return train_step

    hook = tl.make_hook(window, spans)
    ticks = []

    def vis_fn(save_dir, step, batch):
        ticks.append(time.perf_counter())
        hook(save_dir, step, batch)

    with tl.Patched((mf, "make_train_step", make_train_step),
                    (prefetch, "prefetch", tl.timed_prefetch(prefetch.prefetch, spans))):
        tl.run_loop(lambda: driver.run_multiframe_training(
            cfg, template, loader, None, n_frames, log_every=o["log_every"],
            flow_fn=flow_fn, load_pretrained=load_pretrained, load_lpips=load_lpips,
            vis_fn=vis_fn, device=device))
    tl.finish(window)
    log_pacing(window, spans, ticks)
    if set(ks) != {ks[0]}:
        raise RuntimeError(f"the hypotheses a step keeps changed in the window: {ks}")
    k, B, T = ks[0], o["batch_size"], o["num_frames"]
    log(f"the loop kept k = {k} of {o['num_guesses']} hypotheses: {k * B * T} views a step")
    info = {"frames_per_step": B * T,
            "shapes": {"img_size": o["img_size"], "num_faces": int(template.faces.shape[0]),
                       "soft_views": k * B * T, "hard_views": k * B * T,
                       "flow_pairs": B * (T - 1), "flow_net_hw": o["flow_net_hw"]}}
    return window, spans, cap, info


def log_pacing(window, spans, ticks) -> None:
    """The window's step intervals (quartiles, ms) and the host ms a step
    of the harness's spans."""
    gaps = [1e3 * (b - a) for a, b in zip(ticks, ticks[1:]) if a >= window.t0]
    q = statistics.quantiles(gaps, n=4) if len(gaps) > 1 else gaps
    per = {k: round(1e3 * v / window.units, 1) for k, v in sorted(spans.total.items())}
    log(f"pacing: {window.units} steps, interval quartiles ms "
        f"{[round(x, 1) for x in q]}, max {max(gaps, default=0):.1f}; host ms a step {per}")


def mix(cell, cap, info) -> float:
    """Departures from the configuration's mix: the step's views not
    k·B·T at the reference's k; no mask-only clip in the captured batches."""
    views = ref.num_hypotheses(cell) * info["frames_per_step"]
    clips = sum(int((b["kp"].flatten(1) == 0).all(1).sum()) for b in cap.batches)
    log(f"mix: {info['shapes']['soft_views']} views a step (the reference's {views}), "
        f"{clips} mask-only clips in the {len(cap.batches)} captured batches")
    return float((info["shapes"]["soft_views"] != views) + (clips == 0))


def end_to_end(window, info) -> dict:
    return {"train_frames_per_s": window.units * info["frames_per_step"] / window.window_s}


def check(cell, seed: int, device, cap, info) -> dict:
    return dict(ref.compare(cell, seed, device, cap), mix=mix(cell, cap, info))


def control(cell, seed: int, device, kind: str) -> dict:
    return ref.control(cell, seed, device, kind)


def unit_flops(cell, device, info) -> float:
    return ref.step_flops(cell, device)
