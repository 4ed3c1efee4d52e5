"""cdlnet_tpu_torch — the PyTorch/CUDA port of cdlnet_tpu.

Module paths mirror the JAX package, so each counterpart is found by its
name. This package covers the video model, CDLNetVideo, in serving
(serve.Denoiser.denoise_video) and training (train.fit), the 2D image
models CDLNet (JDD with a Bayer mask) and GDLNet in serving
(Denoiser.denoise_image / denoise_image_batch, known or blind sigma) and
training, the frame-recurrent CSR models in serving (denoise_video by
their recurrence) and training, the DnCNN and FFDNet baselines (cuDNN,
BatchNorm training), the eval CLIs (cli.analyze, cli.analyze3d,
cli.analyzemri), and the reference's torch .ckpt files. The LISTA contractions (with the CSR proxes) and the
reverse run on hand-written CUDA kernels for Hopper (kernels/csrc/) when
the tensors lie on the GPU, and on the kernels' plain PyTorch versions
when they lie on the CPU. Entry points run on the card unless they are
given device="cpu".

Layers:
  core/     pad, pre/post-processing, ST and the CSR proxes, uball
            projection, power method, Gabor filters, the bior4.4 wavelet bank
  ops/      torch-semantics conv/conv-transpose, polyphase layout, LISTA loops
  kernels/  the fused 2D and 3D LISTA forward and the 3D reverse (CUDA
            kernels + plain versions), the autograd Function over the 3D
            pair, and their build
  models/   registry, CDLNet, GDLNet, CDLNetVideo, CDLNetCSR,
            CDLNetCSRf2, DnCNN and FFDNet (nn.Module), streaming
  nle/      blind noise-level estimation (MAD, PCA)
  data/     noise injection and observation masks, image, video and
            fastMRI loaders, synthetic fixtures
  train/    clipped Adam, mse, ssim, npz checkpoints (both packages; in
            the background with ckpt_format="orbax"), fit(), fit_csr()
  cli/      the train CLI and the analysis CLIs
  compat/   JAX params dict <-> module state; torch .ckpt read and written
  serve.py  Denoiser, the serving entry point

This package imports torch and numpy only; it never imports jax or
cdlnet_tpu.
"""

__version__ = "0.1.0"
