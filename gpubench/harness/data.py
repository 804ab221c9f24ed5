"""The configurations' data sets, made once per checkout.

A user's data set does not change between runs, so each is generated from
its configuration's `dataset` entry and a fixed data seed into a directory
under gpubench/cache/ named by those parameters, on the first run in a
checkout, and read by every later run. The generators are the frozen
copies in harness/fixtures/; the TigDog tree's per-frame cache (one pkl per
frame, what the multiframe datasets read) is written by the frozen copy of
the data layer's explode step, so that the program and the reference read
the same files and neither reads what the other made.
"""
from __future__ import annotations

import os
import shutil

from .bench import CACHE, log


def _key(spec: dict) -> str:
    parts = [spec["kind"]] + [f"{k}{'x'.join(map(str, v)) if isinstance(v, list) else v}"
                              for k, v in sorted(spec.items()) if k != "kind"]
    return "-".join(parts)


def _make(spec: dict, build) -> str:
    """The directory of `spec`'s data, built by `build(tmp_dir)` when absent."""
    out = os.path.join(CACHE, _key(spec))
    if os.path.exists(os.path.join(out, "DONE")):
        return out
    tmp = out + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    log(f"generating the data set {os.path.basename(out)} (first run in this checkout)")
    build(tmp)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok\n")
    shutil.rmtree(out, ignore_errors=True)
    os.rename(tmp, out)
    # set-up, not the window, pays for writing the data set back to disk
    os.sync()
    return out


def tigdog(spec: dict) -> dict:
    """A TigDog-format tree (`videos` clips of `frames` frames at `raw`)
    with its per-frame cache: {"root_dir", "tmp_dir", "category"}."""
    from ..reference.frozen.data import tigdog as tig
    from .fixtures.tigdog_fixture import write_tigdog_tree

    cat = spec["category"]

    def build(tmp):
        write_tigdog_tree(os.path.join(tmp, "videos"), cat, spec["videos"], spec["frames"],
                          tuple(spec["raw"]), spec["seed"])
        ds = tig.VideoPklDataset(os.path.join(tmp, "videos"), cat, split="train",
                                 num_kps=spec["num_kps"])
        tig.explode_to_frames(ds, os.path.join(tmp, "frames"), cat, spec["frames"])

    out = _make(spec, build)
    return {"root_dir": os.path.join(out, "videos"), "tmp_dir": os.path.join(out, "frames"),
            "category": cat}


def cub(spec: dict) -> str:
    """A CUB-200-2011-format tree; the directory is both the CUB dir and its
    cache dir."""
    from .fixtures.cub_fixture import write_cub_tree

    return _make(spec, lambda tmp: write_cub_tree(tmp, spec["train"], spec["test"],
                                                  tuple(spec["raw"]), spec["seed"]))
