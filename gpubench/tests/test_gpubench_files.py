"""The benchmark's files: every name BENCHMARK.json gives has its file and
the harness finds it; nothing the chip runs imports JAX or the JAX
package; the reference imports nothing of the program."""
from __future__ import annotations

import ast
import glob
import json
import os

import pytest

from gpubench.harness import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "acfm_video_3d_reconstruction_tpu"}
PROGRAM = "acfm_video_3d_reconstruction_tpu_torch"


def imported_tops(path: str) -> set:
    """Top-level names of a file's absolute imports, whole (the part before
    the first dot)."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources(*parts, skip_tests=True):
    files = glob.glob(os.path.join(bench.GPUBENCH, *parts, "**", "*.py"), recursive=True)
    return [f for f in files if not (skip_tests and os.sep + "tests" + os.sep in f)]


def test_top_level_names_compare_whole():
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert "acfm_video_3d_reconstruction_tpu" in FORBIDDEN


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, bench.GPUBENCH))
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, bench.GPUBENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported_tops(path)


def test_every_cell_and_metric_has_its_files():
    b = bench.benchmark()
    for w in b["workloads"]:
        cell = bench.Cell(w["name"], b)
        assert cell.driver().run
        assert set(cell.limits)
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in b["per_layer"]:
        reader = bench.load_module(os.path.join(bench.GPUBENCH, "metrics", m["name"] + ".py"))
        assert callable(reader.read)
    for c in b["configs"]:
        with open(os.path.join(bench.ROOT, c["file"])) as f:
            json.load(f)
        assert c["file"].startswith("gpubench/configs/")


def test_every_kernel_entry_loads():
    from gpubench.harness import readers

    entries = readers.kernel_entries()
    assert len(entries) >= 4
    for k in entries:
        assert callable(k.matches) and callable(k.least_s) and k.KERNEL


def test_per_layer_metrics_only_in_cells_of_their_end_to_end_metric():
    b = bench.benchmark()
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in b["workloads"]]))
           for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
