"""Typed configuration tree (replaces the reference's ~80 mutable absl flags).

Schedule-dependent values that the reference implements by mutating flags at
runtime (hypothesis dropping rewrites opts.num_guesses, finetune_camera
flips opts.use_gtpose: multiframe/nnutils/train_utils.py:236-244) are
explicit schedules here (train/schedules.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    img_size: int = 256
    nz_feat: int = 200
    num_lbs: int = 16
    num_kps: int = 15
    tex_size: int = 6
    subdivide: int = 3
    texture: bool = True
    symmetric: bool = True
    symmetric_texture: bool = True
    learnable_kp: bool = True
    scale_lr: float = 1.0          # multiframe scale head lr multiplier
    use_camera_layernorm: bool = False
    small_camera_init: bool = False
    mesh_path: Optional[str] = None
    kp_dict_path: Optional[str] = None
    scale_mesh: bool = False
    dtype: str = "float32"         # "bfloat16" for the conv trunk fast path


@dataclasses.dataclass(frozen=True)
class MonocularLossWeights:
    """monocular/main.py:36-49 defaults."""

    kp: float = 30.0
    mask: float = 1.0
    cam: float = 2.0
    deform_reg: float = 10.0       # computed, not in the total (main.py:282-293)
    boundaries: float = 1.0
    edt: float = 0.1
    bdt: float = 0.1
    triangle: float = 30.0
    vert2kp: float = 0.16
    tex: float = 0.5
    tex_dt: float = 0.5
    rigid: float = 0.5
    entropy_lbs: float = 0.0016


@dataclasses.dataclass(frozen=True)
class MultiframeLossWeights:
    """multiframe/main.py:62-89 defaults."""

    kp: float = 0.0
    of: float = 1.0
    mask: float = 1.0
    rigid: float = 0.5
    cam: float = 2.0
    deform: float = 2.0            # deform distillation (optimize_deform)
    deform_reg: float = 1.0        # weights the texture cycle loss (main.py:750)
    handle_deform_reg: float = 0.0
    boundaries: float = 1.0
    edt: float = 0.1
    bdt: float = 2.0
    entropy: float = 2.0
    triangle: float = 0.1
    tex: float = 0.5
    tex_dt: float = 0.5


@dataclasses.dataclass(frozen=True)
class MultiplexConfig:
    num_guesses: int = 8
    az_el_cam: bool = False
    scale_lr_decay: float = 0.05
    scale_bias: float = 1.0
    az_euler_range: float = 30.0
    el_euler_range: float = 60.0
    cyc_euler_range: float = 60.0
    optimize_deform: bool = False
    optimize_deform_lr: float = 100.0
    # per-hypothesis pi/4 rotation-bias chain spreading az-el hypotheses in
    # rotation space. The reference BUILDS this chain (mesh_net.py:363-370,
    # cam_biases) but never composes it into the decoded cameras — it is
    # dead code there — so strict parity is False. True keeps the chain as
    # an optional deliberate deviation (wider initial hypothesis spread).
    az_el_quat_bias: bool = False
    drop_hypothesis: bool = False
    # (epoch_threshold, num_guesses) pairs, evaluated in order
    drop_schedule: Tuple[Tuple[int, int], ...] = ((30, 8), (100, 4), (10**9, 4))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 12
    num_frames: int = 2            # clip length (multiframe)
    learning_rate: float = 1e-4
    beta1: float = 0.9
    num_epochs: int = 200
    num_pretrain_epochs: int = 0
    warmup: bool = False           # camera-embedding pose warmup
    texture_warmup: bool = False
    num_reps: int = 20             # pose-warmup epochs
    tex_num_reps: int = 20
    warmup_lr: float = 1e-2        # Adam lr on camera embeddings in warmup
    #                                (reference train_utils.py:187)
    use_gtpose: bool = True
    # MultiStepLR([5,150], gamma=0.1) parity (reference train_utils.py:185
    # constructs it; the shipped loop never steps it, so default off)
    multistep_lr: bool = False
    lr_milestones: Tuple[int, ...] = (5, 150)
    lr_gamma: float = 0.1
    # separate Adam for the camera predictor (reference train_utils.py:181)
    separate_camera_opt: bool = False
    camera_learning_rate: float = 1e-4
    save_epoch_freq: int = 50
    save_latest_freq: int = 0      # mid-epoch 'latest' saves every N steps
    #                                (reference train_utils.py:275-280); 0 = off
    display_freq: int = 0          # visualization panels every N steps; 0 = off
    checkpoint_dir: str = "cachedir/snapshots"
    name: str = "exp_name"
    seed: int = 0
    offset_z: float = 5.0          # monocular renderer; multiframe uses 0.0


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    mono_weights: MonocularLossWeights = MonocularLossWeights()
    mf_weights: MultiframeLossWeights = MultiframeLossWeights()
    multiplex: MultiplexConfig = MultiplexConfig()
    train: TrainConfig = TrainConfig()


# ImageNet normalization used by the reference's resnet_transform.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
