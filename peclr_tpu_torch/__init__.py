"""PyTorch + CUDA port of peclr_tpu for NVIDIA Hopper.

The JAX package `peclr_tpu` is the reference; this package mirrors its layout
(ops/, geometry/, models/, eval/, cli/, data/, train/) and never imports JAX
or anything of `peclr_tpu`.  The Pallas TPU kernels are hand-written CUDA
kernels under csrc/, built by `build.py`.
"""
