"""Multiframe training as users run it: the main loop of the program's
train/driver.py::run_multiframe_training.

The set-up is the multiframe CLI's `train` (cli/multiframe_main.py) with
the configuration's flags: the template, the video data set and its frame
cache, the shuffled and augmented clip loader, the frozen MaskFlownet as
the loop's flow_fn (its pass runs in prep, on the prefetch thread). The
warm-ups, the init pass and the saves are off; the weights are the
benchmark's, made on the card from the seed. The first `warm_steps` steps
are set-up, and the first `capture_steps` of them are kept for the
comparison; then the window runs the loop as it is. The rate is the
frames of every step finished in the window over the window.
"""
from __future__ import annotations

from ..harness import train_loop as tl
from ..harness import weights as W
from ..harness.bench import Spans, Window, log, seconds_since_process_start
from ..harness.data import tigdog
from ..reference import multiframe as ref_mf


def options(cell, tmp: str) -> dict:
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as cli

    o = cli.default_opts()
    o.update(cell.config["cli"])
    o.update(tigdog(cell.config["dataset"]))
    o.update(checkpoint_dir=tmp, name=cell.name, warmup=False, texture_warmup=False,
             init_camera_emb=False, save_epoch_freq=10 ** 9, save_latest_freq=0,
             display_freq=1, num_epochs=10 ** 6)
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
    n_frames, s2v, spv = tig.explode_to_frames(
        cli.build_video_dataset(o), o["tmp_dir"], o["category"], o["num_training_frames"],
        write=False)
    mark("template and frame index")
    dataset = tig.MultiFrameDataset(mirror=o["mirror"], transforms=tr["augment"],
                                    seed=ref_mf.data_seed(seed),
                                    **ref_mf.dataset_kwargs(o, s2v, spv))
    loader = DataLoader(dataset, o["batch_size"], shuffle=tr["shuffle"],
                        seed=ref_mf.loader_seed(seed))

    def load_pretrained(model):
        mark("modules built")
        W.load_into(model, ref_mf.weights_of(cell, seed, device, nets=("meshnet",))["meshnet"])

    def load_lpips(lpips):
        W.load_into(lpips, ref_mf.weights_of(cell, seed, device, nets=("lpips",))["lpips"])

    net = mfn.build(ref_mf.flow_weights(cell, seed, device), device)
    flow_inner = flow_infer.make_flow_fn(net, o["img_size"], o["flow_net_hw"])
    mark("flow net built")
    spans = Spans()
    window = Window(seconds, tr["warm_steps"], tl.sync_of(device), profiler)
    cap = tl.Capture(tr["capture_steps"])

    def flow_fn(batch):
        with spans.span("flow"):
            return flow_inner(batch)

    make_step = mf.make_train_step

    def make_train_step(mods, **kw):
        step = make_step(mods, **kw)
        params = tl.named_params({"model": mods.model, "mpx": mods.mpx})

        def train_step(batch):
            cap.before(params)
            with spans.span("step"):
                metrics = step(batch)
            cap.after(batch, metrics, params, mods.opt, {"probs": mods.mpx.probs})
            return metrics

        return train_step

    with tl.Patched((mf, "make_train_step", make_train_step),
                    (prefetch, "prefetch", tl.timed_prefetch(prefetch.prefetch, spans))):
        tl.run_loop(lambda: driver.run_multiframe_training(
            cfg, template, loader, None, n_frames, log_every=o["log_every"],
            flow_fn=flow_fn, load_pretrained=load_pretrained, load_lpips=load_lpips,
            vis_fn=tl.make_hook(window, spans), device=device))
    tl.finish(window)
    G, B, T = o["num_guesses"], o["batch_size"], o["num_frames"]
    info = {"frames_per_step": B * T,
            "shapes": {"img_size": o["img_size"], "num_faces": int(template.faces.shape[0]),
                       "soft_views": G * B * T, "hard_views": G * B * T,
                       "flow_pairs": B * (T - 1), "flow_net_hw": o["flow_net_hw"]}}
    return window, spans, cap, info


def end_to_end(window, info) -> dict:
    return {"train_frames_per_s": window.units * info["frames_per_step"] / window.window_s}


def check(cell, seed: int, device, cap, info) -> dict:
    return ref_mf.compare(cell, seed, device, cap)


def control(cell, seed: int, device, kind: str) -> dict:
    return ref_mf.control(cell, seed, device, kind)


def unit_flops(cell, device, info) -> float:
    return ref_mf.step_flops(cell, device)
