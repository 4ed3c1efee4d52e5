"""cdlnet_tpu_torch — the PyTorch/CUDA port of cdlnet_tpu.

Module paths mirror the JAX package, so each counterpart is found by its
name. This package covers the video model, CDLNetVideo: serving
(serve.Denoiser) and training (train.fit). The LISTA contraction and its
reverse run on hand-written CUDA kernels for Hopper (kernels/csrc/) when
the tensors lie on the GPU, and on the kernels' plain PyTorch versions
when they lie on the CPU. Entry points run on the card unless they are
given device="cpu".

Layers:
  core/     pad, pre/post-processing, ST, uball projection, power method
  ops/      torch-semantics conv/conv-transpose, polyphase layout, LISTA loop
  kernels/  the fused 3D LISTA and its reverse (CUDA kernels + plain
            versions), the autograd Function over them, and their build
  models/   registry and CDLNetVideo (nn.Module)
  data/     noise injection and observation masks
  train/    clipped Adam, mse, npz checkpoints (both packages), fit()
  compat/   JAX params dict <-> module state
  serve.py  Denoiser, the serving entry point

This package imports torch and numpy only; it never imports jax or
cdlnet_tpu.
"""

__version__ = "0.1.0"
