"""One process, no group: the stand-in for the port's parallel/mesh.py that
the frozen copies import. The reference always runs the whole batch in one
process, which is what the port's data-parallel steps are held to."""
from __future__ import annotations


def world_size() -> int:
    return 1


def rank() -> int:
    return 0


def active() -> bool:
    return False


def is_main() -> bool:
    return True


def shard_batch(batch):
    return batch


def reduce_metrics(metrics: dict) -> dict:
    return metrics


def all_reduce_grads(params) -> None:
    raise RuntimeError("no process group in the reference")


def all_reduce_autograd(x):
    return x


def gather_rows(x):
    return x
