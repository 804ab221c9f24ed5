"""Keypoint group assignments per category (leg/head/torso/tail).

Counterpart of acfm_video_3d_reconstruction_tpu/data/kp_splits.py (a copy):
maps keypoint names to semantic groups for evaluation breakdowns
(reference multiframe/data/kp_splits.py).
"""
from __future__ import annotations

QUADRUPED_GROUPS = {
    "leg": [
        "L_B_Elbow", "L_B_Paw", "L_F_Elbow", "L_F_Paw",
        "R_B_Elbow", "R_B_Paw", "R_F_Elbow", "R_F_Paw",
    ],
    "head": ["Nose", "L_EarBase", "L_Eye", "R_Eye", "R_EarBase"],
    "torso": ["Withers", "Throat", "TailBase"],
}

BIRD_GROUPS = {
    "head": ["FHead", "Crown", "LEye", "REye", "Throat", "Beak", "Nape"],
    "torso": ["Belly", "Breast", "LWing", "RWing", "LLeg", "RLeg"],
    "tail": ["Tail"],
}


def get_kp_splits(kp_names: list[str], category: str) -> dict[str, list[int]]:
    """Keypoint-name list + category -> {group: [kp indices]}."""
    if category in ("horse", "cow", "sheep", "tiger"):
        groups = QUADRUPED_GROUPS
    elif category == "bird":
        groups = BIRD_GROUPS
    else:
        return {}
    name2idx = {n: i for i, n in enumerate(kp_names)}
    return {
        g: [name2idx[n] for n in names if n in name2idx]
        for g, names in groups.items()
    }
