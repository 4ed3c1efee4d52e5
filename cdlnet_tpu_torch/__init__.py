"""cdlnet_tpu_torch — the PyTorch/CUDA port of cdlnet_tpu.

Module paths mirror the JAX package, so each counterpart is found by its
name. This slice covers the video-denoising serve path (CDLNetVideo through
serve.Denoiser); the LISTA contraction runs on hand-written CUDA kernels for
Hopper (kernels/csrc/lista3d.cu) when the tensors lie on the GPU, and on the
kernels' plain PyTorch versions when they lie on the CPU.

Layers:
  core/     pad, pre/post-processing, ST, uball projection, power method
  ops/      torch-semantics conv/conv-transpose, polyphase layout, LISTA loop
  kernels/  the fused 3D LISTA (CUDA kernels + plain versions) and their build
  models/   registry and CDLNetVideo (nn.Module)
  train/    npz checkpoint reading
  compat/   JAX params dict <-> module state
  serve.py  Denoiser, the serving entry point

This package imports torch and numpy only; it never imports jax or
cdlnet_tpu.
"""

__version__ = "0.1.0"
