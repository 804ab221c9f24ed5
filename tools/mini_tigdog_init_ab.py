"""The mini-TigDog run of the PyTorch port from the JAX package's initial weights.

    python tools/mini_tigdog_init_ab.py dump INIT.pkl
    python3 tools/mini_tigdog_init_ab.py train INIT.pkl [--epochs 40] [--root DIR]

The port's tool (tools/torch_mini_tigdog_parity.py) trains from torch's
initial weights (seed 0) and the JAX tool from flax's (PRNGKey(0)), so their
tables differ by the initial weights as well as by the two implementations.
`dump` (JAX, on the CPU) writes the flax init of the tool's model and its
multiplex tables (jmf.build at the tool's options, N_FRAMES training frames)
to a pickle of numpy arrays; `train` (the port, on the card; imports no JAX)
runs the port tool's generator and training options from that init
(models/from_jax.py::load_jax_multiframe after the build) and evaluates the
columns COLUMNS in-process, printing each.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import sys
import tempfile

TOOLS = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, osp.dirname(TOOLS))
sys.path.insert(0, TOOLS)

import torch_mini_tigdog_parity as tt  # noqa: E402

N_FRAMES = 276  # the tool's training frames at its defaults (46 train videos x 6)
COLUMNS = ("after", "train_argmax", "gtcam_al")


def dump(path):
    import jax
    import numpy as np

    from acfm_video_3d_reconstruction_tpu.cli import multiframe_main as jcli
    from acfm_video_3d_reconstruction_tpu.train import multiframe as jmf

    o = tt.train_opts("unused", 40)
    o.pop("device")
    cfg = jcli.build_cfg(o)
    _, _, state = jmf.build(cfg, jcli.build_mf_template(cfg), N_FRAMES, jax.random.PRNGKey(0),
                            steps_per_epoch=N_FRAMES // o["batch_size"])

    def tree(x):
        return jax.tree_util.tree_map(np.asarray, x)

    with open(path, "wb") as fh:
        pickle.dump({"params": tree(state.params), "batch_stats": tree(state.batch_stats),
                     "lpips": None if state.lpips_params is None else tree(state.lpips_params),
                     "cams": np.asarray(state.multiplex.cams),
                     "probs": np.asarray(state.multiplex.probs)}, fh)
    print(f"wrote the JAX init ({N_FRAMES} multiplex rows) to {path}")


def train(path, epochs, root):
    import torch

    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as mfe
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main
    from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    with open(path, "rb") as fh:
        init = pickle.load(fh)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", osp.join(root, "torchinductor"))
    tt.generate(root, tt.build_template(), device)
    o = tt.train_opts(root, epochs, device="cuda")
    real_build = mf.build

    def build(*args, **kwargs):
        mods = real_build(*args, **kwargs)
        from_jax.load_jax_multiframe(mods, init["params"], init["batch_stats"], init["lpips"],
                                     {"cams": init["cams"], "probs": init["probs"],
                                      "deform": None, "deform_mirror": None})
        return mods

    mf.build = build
    try:
        multiframe_main.train(o)
    finally:
        mf.build = real_build
    for key in COLUMNS:
        stats = mfe.evaluate(tt.eval_opts(o, tt.plan_flags(key, 60)))
        print(f"from the JAX init, {epochs} epochs, {key}: {stats.results()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("dump", "train"))
    ap.add_argument("init", help="the pickle of the JAX init")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--root", default=osp.join(tempfile.gettempdir(), "mini_tigdog_init_ab"))
    args = ap.parse_args(argv)
    if args.mode == "dump":
        dump(args.init)
    else:
        train(args.init, args.epochs, args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
