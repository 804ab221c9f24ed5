"""PyTorch + CUDA port of acfm_video_3d_reconstruction_tpu (NVIDIA H100).

Mirrors the JAX package's layout (geometry/, deform/, ops/, models/,
losses/, train/, eval/). It imports torch, numpy and scipy, never JAX or
the JAX package. Entry points run on "cuda" unless the caller passes
device="cpu". The TPU Pallas kernels become hand-written CUDA kernels
under csrc/, built with nvcc at first use (ops/cuda_build.py).
"""
