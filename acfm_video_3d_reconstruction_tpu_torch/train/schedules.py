"""Explicit training-phase schedules.

A copy of acfm_video_3d_reconstruction_tpu/train/schedules.py (pure
Python). The reference mutates absl flags at runtime to implement these
(multiframe/nnutils/train_utils.py:236-244); here they are pure functions
of the epoch.
"""
from __future__ import annotations

from typing import Tuple


def num_guesses_at(
    epoch: int,
    base_guesses: int,
    drop_hypothesis: bool,
    use_gtpose: bool,
    schedule: Tuple[Tuple[int, int], ...] = ((20, 8), (100, 4), (10**9, 2)),
) -> int:
    """Hypothesis-drop schedule (epochs <=20: all; <=100: 4; then 2)."""
    if not drop_hypothesis or use_gtpose:
        return base_guesses
    for thresh, k in schedule:
        if epoch <= thresh:
            return min(k, base_guesses)
    return min(schedule[-1][1], base_guesses)


def use_gtpose_at(epoch: int, use_gtpose: bool, finetune_camera: bool, switch_epoch: int = 30) -> bool:
    """finetune_camera flips use_gtpose off from epoch 30 (train_utils.py:243)."""
    if finetune_camera and epoch >= switch_epoch:
        return False
    return use_gtpose
