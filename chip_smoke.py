#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's video serve, 2D image serve, video
training, 2D image training, native-resolution video and frame-recurrent
CSR serving and training paths, the input pipeline, blind PCA noise
estimation, CDLNetVideo's residual blocks, the DnCNN/FFDNet baselines,
reference torch .ckpt checkpoints, the HTTP server and the MC-SURE and
combined losses on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from cdlnet_tpu_torch/kernels/csrc
(one nvcc per source, in parallel), then

  serve     at the flagship video model (CDLNetVideo K=30, M=169,
            P=(7,7,5), s=2, adaptive) checks the 3D forward kernels against
            their plain PyTorch versions on a 16x128x128 clip, serves three
            clips through Denoiser.denoise_video and counts the kernel
            launches, and denoises a clip with the trained
            examples/cdlnet-video-demo model;
  serve 2D  at the flagship 2D model (CDLNet K=30, M=169, P=7, s=2,
            adaptive) checks the 2D forward kernels against their plain
            versions at 128^2 and 320x480 (and JDD's C=3, s=1 form with a
            Bayer mask), the K=30 forward against the plain loop at 128^2,
            512^2 and 320x480 (and the reference JDD config at 128^2),
            serves images through Denoiser.denoise_image / _batch with the
            trained examples/cdlnet-flagship-demo model (known and blind
            sigma, counting the launches), and runs the jdd, gdlnet and
            cdlnet demos on the kernels and on backend "xla";
  train     at the video training shape (N=2 clips of 16x128x128, sigma in
            [20, 30]) checks the reverse kernels against their plain
            versions (the weight gradient dense and on the phase rows the
            reverse loop passes it), the K=30 gradient through the kernels against torch
            autograd on backend "xla" (and two backward runs for bitwise
            equality), and runs fit() for 20 steps, counting the launches
            per step and reloading its checkpoint;
  train 2D  at the flagship 2D training shape (CDLNet K=30, M=169, P=7,
            s=2, N=10 crops of 128^2 cut from data/synthetic.natural_image,
            sigma in [20, 30]) checks the 2D reverse kernels against their
            plain versions (and at JDD's C=3, s=1 masked form and a C=3,
            s=2 form), the gradients through the kernels against backend
            "xla" and bitwise repeatable (the flagship at 10 x 128^2 and
            1 x 256^2, the reference JDD config with a Bayer mask, GDLNet),
            runs fit(workload="2d") for 20 steps, counting the launches
            per step and reloading its checkpoint, and trains the same
            width for two epochs through the train CLI (cli.train.main on
            image directories written by data/synthetic.py, on the card by
            default), reloading the checkpoint and args.json it saves;
  bigframe  native-resolution video at the flagship width (the shapes of
            the TPU's banded and ring kernels K9-K12, which the same 3D
            kernels replace): the forward kernels against their plain
            versions at 16x480x854 (bucketed to 512x896), 16x240x432 and
            the fastMRI config's P=(9,9,5) at 30x320x192, the K=30 forward
            against the plain loop at the first and last; a native clip
            through Denoiser.denoise_video (launches counted) and the
            trained video demo at native size, known and blind sigma; a
            48-frame native clip streamed in chunks and a native clip in
            256^2 tiles against backend "xla", the pipelined host loop
            against the staged one; the eval CLI (cli.analyze3d.main on
            the card) on native clips written as PNG frames, its txt line,
            eval row, PNGs and launches, again with --blind PCA, and the
            passthrough codes against the plain loop; the reverse kernels
            and the K=30 gradient at 1x8x256^2, the reverse kernels on a
            native forward's histories at 1x16x480x854, one train step
            there, and two epochs of the train CLI's video branch with its
            batches assembled in the calling thread and by 4 loader
            threads (the loader's host ms per batch and the CLI's ms per
            step beside the flagship step's);
  csr       frame-recurrent CSR serving at the reference's argscsr.json
            width (CDLNet_CSR and CDLNet_CSRf2, K=30, M=169, P=9, s=2,
            adaptive) on fastMRI's native 640x368 frames: the CSR analysis
            kernels (one code, two codes, the following code alone) and the
            ST one against their plain versions at 2x128^2 and 640x368
            (and its 640x384 bucket), the K=30 forwards against the plain
            loop, a 16-frame native volume through Denoiser.denoise_video
            for both models, known and blind sigma (launches counted; the
            CSRf2 volume blind PCA too), the trained examples/csr-demo on
            smooth 128^2 volumes, and cli.analyzemri.test on native
            volumes;
  csr_train frame-recurrent CSR training at the same width: the CSR adjoint
            kernels (one code, the following code alone, two codes) and
            the P=9 synthesis, the soft-threshold adjoint and the weight
            gradient against their plain versions at 1x128^2 and 640x368
            (and its 640x384 bucket), on a K=30 forward's u and z
            histories; the K=30 gradients through the kernels against
            backend "xla" for both models, every parameter and the carried
            codes, bitwise repeatable; make_csr_train_step at native
            640x368 (launches counted, remat bitwise equal to no remat,
            step ms and peak GB on the kernels and on "xla"); and fit_csr
            for 20 steps of CDLNet_CSRf2 on 2 x 3 x 128^2 volumes, its
            launches per step and a checkpoint that reloads;
  prefetch  data/prefetch.py::device_prefetch over 8 batches of the video
            train shape with a kernel on the consumer's stream between
            yields: every batch bitwise equal to its host batch, every
            host-to-device copy off the consumer's stream (a torch.profiler
            trace);
  blind PCA the trained flagship 2D demo through denoise_image (128^2,
            481x321) and denoise_image_batch (8 x 128^2, sigma 10 to 50)
            with blind="PCA": sigma-hat within 15% of sigma and within 1e-3
            of the CPU's, PSNR gains against the known sigma's; a native
            16x480x854 clip at the flagship width, blind PCA, with the
            estimator's share of its latency;
  residual  CDLNetVideo with residual blocks (the plain F.conv3d loop on
            every backend): the reference golden on the card, the flagship
            width serving a 16x128^2 clip with no kernel launch, and one
            train step at N=2 (loss, ms, peak memory);
  baselines DnCNN (DnCNN-S: K=17, M=64, P=3) and FFDNet (C=1, K=15, M=64,
            P=3) on cuDNN, with BatchNorm: 20 fit() steps on 128 crops of
            40^2 / 50^2 (losses falling, running statistics moving, a
            checkpoint that reloads them bitwise), the eval forward and one
            training step (float64 and fp32) on the card against the CPU,
            Denoiser on a
            481x321 image and a batch of 8 x 128^2 (latency, images/s), two
            epochs of the train CLI for DnCNN and cli.analyze on its
            checkpoint;
  ckpt      reference torch .ckpt files on the kernels: the video, 2D
            flagship and CSR demos exported by save_torch_checkpoint and
            served from the .ckpt through Denoiser.from_args, bitwise the
            .npz route with the same launches; the flagship video model
            resumed for 5 fit() steps from a .ckpt with Adam state, bitwise
            the losses of an .npz resume; fit(ckpt_format="orbax"), whose
            background-saved .npz reloads equal;
  server    the HTTP front end (server.py) serving the trained flagship 2D
            demo and the video demo on the card: 32 concurrent 128^2
            requests at mixed sigma from 8 client threads, each within 1e-4
            of denoise_image, one K + K forward per coalesced batch
            (requests/s, p50/p99, the /metrics batch sizes; again at
            max_batch 1), a blind request, 400s for bad bodies, a 481x321
            image and a clip against the Denoiser calls (the clip bitwise),
            coalesced batches and handler-thread calls disjoint on the
            card's timeline, and `python -m cdlnet_tpu_torch.server` in
            processes of its own (max_batch 8 and 1: one image, then the
            same traffic);
  losses    MC-SURE at the flagship 2D (10 x 128^2) and video (2 x 16x128^2)
            training shapes: loss and gradients on the kernels and on
            backend "xla" against "xla" in float64, two backward runs
            bitwise equal, twice an mse step's launches, step ms and peak
            GB beside the mse step's; 20 fit(mcsure=True) steps of the 2D
            flagship (falling losses, a held-out PSNR gain); a combmse
            video step with seeded VGG16 weights at a temporary path and
            without them (warned once), its loss on the card against the
            CPU's, step ms and peak GB;

and times every kernel (CUDA events) beside its plain version, the one
PyTorch call that computes the same function, and its bound on this card
(for the 3D and 2D forward pairs and the reverse pair, which run on the
tensor cores in 3xTF32, at three TF32 products a term over the taps that
are not structurally zero), the new launch grids on "grid" lines,
and the served clip and image and the video and image train steps on the
kernels and on backend "xla". Any failed phase raises and the script exits non-zero;
without a CUDA device it exits 1 before printing any result. The last line
of stdout is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

preceded by the card's nvidia-smi name and power limit and by a JSON line
{"kernels": [...]} with each kernel's launches, error, times and bound.
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import io
import json
import os
import queue
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from cdlnet_tpu_torch import nle
from cdlnet_tpu_torch.cli import analyze, analyze3d, analyzemri
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.cli.analyze import build_argparser
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.compat.torch_ckpt import save_torch_checkpoint
from cdlnet_tpu_torch.core.ops import csr_f2_jump, prox_csr, prox_csr_f2
from cdlnet_tpu_torch.core.preprocess import post_process, pre_process, pre_process_3d
from cdlnet_tpu_torch.data.noise import gen_bayer_mask
from cdlnet_tpu_torch.data.prefetch import device_prefetch
from cdlnet_tpu_torch.data.synthetic import (
    gen_natural_image_dirs,
    gen_synthetic_mri_dirs,
    gen_synthetic_video_dirs,
    natural_image,
)
from cdlnet_tpu_torch.kernels import _build
from cdlnet_tpu_torch.kernels import lista2d as L2
from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
from cdlnet_tpu_torch.kernels import lista3d as L
from cdlnet_tpu_torch.kernels import lista3d_bwd as LB
from cdlnet_tpu_torch.models import (
    CDLNet,
    CDLNetCSR,
    CDLNetCSRf2,
    CDLNetVideo,
    DnCNN,
    FFDNet,
    GDLNet,
    streaming,
)
from cdlnet_tpu_torch.ops import polyphase as pp
from cdlnet_tpu_torch.ops.conv import conv_transpose2d, conv_transpose3d
from cdlnet_tpu_torch.models.cdlnet import _prepare
from cdlnet_tpu_torch.ops.lista import _threshold, lista_2d, lista_3d
from cdlnet_tpu_torch.serve import Denoiser
from cdlnet_tpu_torch.server import DenoiseServer
from cdlnet_tpu_torch.tools import compare_sass
from cdlnet_tpu_torch.tools.bench_video_serve import graph_ms
from cdlnet_tpu_torch.train.checkpoint import load_ckpt, save_ckpt
from cdlnet_tpu_torch.train.fit import fit, init_model, make_train_step, train_update
from cdlnet_tpu_torch.train.fit_csr import fit_csr, make_csr_train_step
from cdlnet_tpu_torch.train import losses as losses_mod
from cdlnet_tpu_torch.train.losses import mcsure_loss, mse_loss
from cdlnet_tpu_torch.train.optim import get_lr, make_optimizer
from cdlnet_tpu_torch.utils import img_save, load_video

FLAGSHIP = dict(K=30, M=169, P=(7, 7, 5), s=2, C=1, adaptive=True, depth=16)
CLIP = (16, 128, 128)
SIGMA = 25.0
TRAIN_N = 2                 # clips per training batch
TRAIN_SIGMA = (20.0, 30.0)  # per-sample sigma range of the training noise
FIT_STEPS = 20
SEED = 0
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
DEMO = os.path.join(EXAMPLES, "cdlnet-video-demo")
# the 2D path: the reference's flagship CDLNet-s2030 width, its trained demo,
# and the reference JDD_CDLNet-s0120 config (KERNELMATRIX.json's 2D eval
# rows "2d-flagship eval 128^2 / 512^2 / 320x480", "jdd eval 128^2 masked")
FLAGSHIP_2D = dict(K=30, M=169, P=7, s=2, C=1, adaptive=True)
JDD_2D = dict(K=42, M=64, P=7, s=1, C=3, adaptive=True)
JDD_PARITY = dict(K=8, M=48, P=7, s=1, C=3, adaptive=True)  # examples/jdd-demo's width
DEMO_2D = os.path.join(EXAMPLES, "cdlnet-flagship-demo")
IMAGE = (128, 128)
BIG_IMAGE = (321, 481)      # BSD68's size: buckets to 384x512
BATCH_SIGMAS = [15.0, 25.0, 35.0, 25.0]
THROUGHPUT_BATCH = 8
# the 2D training path: the reference's batch of 10 crops of 128^2 (and the
# KERNELMATRIX row "2d-flagship train 256^2", the TPU's banded class),
# GDLNet at the flagship width, and a stride-2 colour form whose phase map
# a 3D one would get wrong
TRAIN_2D_N = 10
CROP = 128
BIG_CROP = 256
GDLNET_2D = dict(K=30, M=169, P=7, s=2, C=1, order=1, adaptive=True)
COLOR_S2_2D = dict(K=3, M=64, P=7, s=2, C=3, adaptive=True)
# fit(workload="2d") from the power-method init: the reference's lr and a
# global-norm clip, as the 3D phase runs
FIT_2D_LR, FIT_2D_CLIP = 1e-3, 0.05
# the train CLI's run: the flagship demo's args.json (the reference's
# CDLNet-s2030 config: 10 crops of 128^2 a batch) on 20 training images of
# 180^2, 8 val and 4 test images, for two epochs
CLI_TRAIN_IMAGES, CLI_TEST_IMAGES, CLI_EPOCHS = 20, 4, 2
CSRC = "cdlnet_tpu_torch/kernels/csrc/"
K5, K7 = "cdlnet_tpu/kernels/lista2d.py:185", "cdlnet_tpu/kernels/lista2d_tiled.py"
K6_K8 = "cdlnet_tpu/kernels/lista2d.py:399; cdlnet_tpu/kernels/lista2d_tiled_bwd.py:110"
# the TPU's big-frame 3D kernels, which the 3D kernels below replace at every
# frame size: K9 the banded forward pair, K10 its reverse, K11 the depth-ring
# forward (its syn + ana merged per iteration), K12 the ring reverse
K9 = "cdlnet_tpu/kernels/lista3d_tiled.py"
K10 = "cdlnet_tpu/kernels/lista3d_tiled_bwd.py"
K11 = ("cdlnet_tpu/kernels/lista3d_ring.py:501 _kernel_first, :458 _kernel_mid, "
       ":516 _kernel_mid_hist, :528 _kernel_last")
K12 = "cdlnet_tpu/kernels/lista3d_ring_bwd.py:331 _kernel_rb_init, :374 _kernel_rb_mid"
# kernel -> (source, the TPU kernel(s) it replaces)
KERNELS = {
    "lista3d_ana_threshold": (CSRC + "lista3d.cu", "cdlnet_tpu/kernels/lista3d.py:325; "
                              f"{K9}:176 _kernel_ana3_band; {K11}"),
    "lista3d_syn_residual": (CSRC + "lista3d.cu", "cdlnet_tpu/kernels/lista3d.py:325; "
                             f"{K9}:120 _kernel_syn3_band; {K11}; as the analysis "
                             f"adjoint {K10}:147 _kernel_ds_band; {K12}"),
    "lista3d_syn_adjoint": (CSRC + "lista3d.cu",
                            "cdlnet_tpu/kernels/lista3d_bwd_resident.py:99; "
                            f"{K10}:199 _kernel_dz_band; {K12}"),
    "lista3d_wgrad": (CSRC + "lista3d_bwd.cu",
                      "cdlnet_tpu/kernels/lista3d_bwd_resident.py:99; "
                      f"{K10}:199 _kernel_dz_band; {K12}"),
    "lista2d_ana_threshold": (CSRC + "lista2d.cu", f"{K5}; {K7}:175"),
    "lista2d_syn_residual": (CSRC + "lista2d.cu", f"{K5}; {K7}:140"),
    # the 2D reverse pair: the 2D analysis's mainloop with the adjoint
    # epilogue, and lista3d_bwd.cu's weight gradient at D = Qd = 1
    "lista2d_syn_adjoint": (CSRC + "lista2d.cu", K6_K8),
    "lista2d_wgrad": (CSRC + "lista3d_bwd.cu", K6_K8),
    # the CSR prox modes of K5 and K7: lista2d_mma.cuh's analysis with the
    # prox in its epilogue (one neighbour code: "csr"; two: "csrf2")
    "lista2d_ana_csr": (CSRC + "lista2d.cu", f"{K5} _kernel prox 'csr' (:273-295); "
                        f"{K7}:175 _kernel_ana_band prox 'csr' (:189-250)"),
    "lista2d_ana_csrf2": (CSRC + "lista2d.cu", f"{K5} _kernel prox 'csrf2' (:273-295); "
                          f"{K7}:175 _kernel_ana_band prox 'csrf2' (:189-250)"),
    # the CSR prox modes of K6: lista2d_mma.cuh's analysis with the prox's
    # adjoint in its epilogue
    "lista2d_syn_adjoint_csr": (CSRC + "lista2d.cu", "cdlnet_tpu/kernels/lista2d.py:399 "
                                "_kernel_bwd prox 'csr' (:548-563)"),
    "lista2d_syn_adjoint_csrf2": (CSRC + "lista2d.cu", "cdlnet_tpu/kernels/lista2d.py:399 "
                                  "_kernel_bwd prox 'csrf2' (:564-603)"),
}
# the native-resolution path (the shapes of K9-K12): DAVIS's 480x854 test
# clips, which cli/analyze3d.py evaluates at full resolution (Denoiser
# buckets them to 512x896), and KERNELMATRIX.json's big-frame rows "3d eval
# 16x240x432 ring f32", "mri eval 30x320x192 ring (9,9,5) f32" (the
# reference's fastMRI config, tools/hw_kernel_sweep.py:197) and "3d train
# 8x256^2 ring-bwd / banded-bwd f32h"
NATIVE = (16, 480, 854)
HALF_NATIVE = (16, 240, 432)
MRI_3D = dict(K=30, M=169, P=(9, 9, 5), s=2, C=1, adaptive=True, depth=30)
MRI_VOLUME = (30, 320, 192)
BIG_TRAIN = (8, 256, 256)
CHUNK, OVERLAP = 16, 4      # a 48-frame native clip streams in five chunks
TILE, TILE_OVERLAP = 256, 16
CLI_VIDEOS = 2              # native test clips of the eval CLI
CLI_TRAIN_VIDEOS, CLI_VIDEO_SIZE = 8, 96  # the video train CLI's clips per split
# matplotlib is not installed beside the card (a probe's import failed
# there), so the eval CLI runs without --thresholds, the one analysis that
# needs it; the CPU tests run it
CARD_HAS_MATPLOTLIB = False
# the CSR path: the reference's argscsr.json width (tools/hw_kernel_sweep.py:
# 25,199; tools/bench_csr_bigframe.py:23) on fastMRI's native 640x368 frames
# (tests/test_kernels.py:1421), which Denoiser buckets to 640x384 (a 320x192
# code grid), and at 2 x 128^2 with per-image sigma: KERNELMATRIX.json's
# "csr ... eval" rows (n_codes 0, 1, 2)
CSR_WIDTH = dict(K=30, M=169, P=9, s=2, C=1, adaptive=True)
MRI_FRAME = (640, 368)
CSR_DEPTH = 16              # frames of the served native volume
CSR_DEMO = os.path.join(EXAMPLES, "csr-demo")
CSR_CLI_VOLUMES = 2         # native volumes of the eval CLI's test
# prox_csr_f2 jumps by up to 2 tau gam1 where its argument v crosses Ca, and
# a kernel's v differs from its plain version's by fp32 reassociation: a
# two-sided call is held at KERNEL_TOL over the codes with |v - Ca| >
# CSR_JUMP_EPS max|v|, and what runs through the two-sided prox K times (a
# K=30 forward, a served volume) by its relative L2 error and its PSNR gap
CSR_JUMP_EPS = 1e-5
CSR_L2_TOL = 1e-4
CSR_PSNR_GAP_DB = 0.01
# fit_csr's run at the argscsr width from the power-method init
FIT_CSR_LR = 5e-4
# launches per train step: forward K + K, reverse K syn_adjoint, K-1
# syn_residual (the analysis adjoint) and 2K wgrad (dA and dB)
STEP_LAUNCHES = {"lista3d_ana_threshold": 30, "lista3d_syn_residual": 59,
                 "lista3d_syn_adjoint": 30, "lista3d_wgrad": 60}
# the pipeline, blind PCA and residual phases: prefetch over 8 batches of the
# flagship train shape; the PCA sigma-hat within 15% of the true sigma (the
# JAX package's recovery tolerance, tests/test_nle.py), the card's within
# 1e-3 of the CPU's (fp32 eigenvalues), and a blind PSNR gain within 0.1 dB
# of the known sigma's; the train CLI's video branch at 0 and 4 loader
# threads; the reference golden of residual blocks
PREFETCH_BATCHES = 8
PCA_BATCH_SIGMAS = [float(v) for v in np.linspace(10.0, 50.0, 8)]
PCA_SIGMA_TOL = 0.15
PCA_CPU_TOL = 1e-3
PCA_GAIN_GAP_DB = 0.1
DEMO_2D_SIGMAS = (15.0, 35.0)  # examples/cdlnet-flagship-demo's training noise_std
CLI_WORKERS = (0, 4)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
# the baselines on cuDNN: DnCNN-S (cdlnet_tpu/models/dncnn.py:52-59) and
# FFDNet's published grayscale width, trained on 128 crops a batch of 40^2
# and 50^2 (their papers' patch sizes) at sigma 25 with Adam at 1e-3; the
# card against the CPU on the same weights and inputs
DNCNN_WIDTH = dict(K=17, M=64, P=3)
FFDNET_WIDTH = dict(C=1, K=15, M=64, P=3)
BASE_CROPS = {"DnCNN": 40, "FFDNet": 50}
BASE_BATCH = 128
BASE_PARITY_N = 16          # crops of the card-vs-CPU training step
BASE_FWD_TOL = 1e-4         # forward and running statistics, max|d| / max|ref|
# loss and gradients of one step, max|d| / max|ref|, in float64 on both
# devices: in fp32 the backward through 13-15 BatchNorm layers alone moves
# the gradients up to ~1e-3 from float64 on the card and on the CPU alike
# (PERF.md, Findings), so fp32 holds the loss and statistics
BASE_STEP_TOL = 1e-3
RESUME_STEPS = 5            # fit() steps of the flagship resumed from a .ckpt
# the HTTP front end: 32 single 128^2 requests from 8 client threads, and the
# entry point as a user starts it; the combined loss's VGG16 convs through
# relu3_3 (torchvision's features index, out and in channels), seeded
# He-normal weights in place of the pretrained ones, which are not fetched
SERVER_REQUESTS, SERVER_THREADS = 32, 8
# MC-SURE's gradient backpropagates the probe's random signs at every
# position (scaled by 1/h = 1e3): summed over the positions they cancel, and
# in fp32 the plain cuDNN loop lands 1.2e-3 to 8.4e-3, the kernels 8.2e-4 to
# 1.9e-2 (2-3x cuDNN's error, as on the mse gradient) from the float64
# gradient (PERF.md, Findings), where a pass run on the other's
# histories or a lost reverse loop is off by O(1); the passes' separate
# histories are held bitwise (the passes in either order)
MCSURE_GRAD_TOL = 5e-2
ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_CMD = [sys.executable, "-m", "cdlnet_tpu_torch.server", DEMO_2D, "--port", "0",
             "--warmup", "128x128"]
VGG16_CONVS = [(0, 64, 3), (2, 64, 64), (5, 128, 64), (7, 128, 128), (10, 256, 128),
               (12, 256, 256), (14, 256, 256)]
KERNEL_TOL = 1e-4   # one kernel call vs its plain version, max|d| / max|ref|
FORWARD_TOL = 1e-3  # the K=30 forward on the kernels vs the plain loop
# the K=30 gradient on the kernels vs torch autograd through cuDNN: both
# fp32, summed in other orders through 30 forward and 30 reverse steps
GRAD_TOL = 1e-3
MIN_GAIN_DB = 3.0
# published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, HBM3,
# and TF32 on the tensor cores (dense), which every kernel (TC_KERNELS: the
# 3D and 2D forward pairs, the reverse pair, the CSR analyses and adjoints)
# runs as three products per fp32 product (3xTF32)
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
TF32_FLOPS = 495e12
TC_KERNELS = ("lista3d_ana_threshold", "lista3d_syn_residual", "lista2d_ana_threshold",
              "lista2d_syn_residual", "lista3d_syn_adjoint", "lista3d_wgrad",
              "lista2d_syn_adjoint", "lista2d_wgrad", "lista2d_ana_csr", "lista2d_ana_csrf2",
              "lista2d_syn_adjoint_csr", "lista2d_syn_adjoint_csrf2")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, max|got - ref| / max|ref|)."""
    d = float((got - ref).abs().max())
    return d, d / float(ref.abs().max())


def cuda_ms(fn, reps: int, rounds: int = 5, warmup: int = 2) -> float:
    """Median over `rounds` of the CUDA-event time per call of `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def host_ms(fn, rounds: int = 5, warmup: int = 1) -> float:
    """Median host-clock ms of fn() followed by a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def bound(banks, n_positions, tensors, calls=1, tf32x3=False) -> tuple[float, str]:
    """The least ms per call for `calls` correlation calls on this card:
    their FMAs (two operations each) over the nonzero entries of each call's
    bank at every code position, against every input read once and every
    output written once (`tensors`), over the published fp32 and memory
    rates. With `tf32x3` the FMAs run as three TF32 products each on the
    tensor cores (the forward pairs' fp32 contract), over the dense TF32
    rate."""
    ops = 2.0 * n_positions * sum(int(torch.count_nonzero(b)) for b in banks)
    nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    t_ops = 3 * ops / TF32_FLOPS if tf32x3 else ops / FP32_FLOPS
    t_bytes = nbytes / HBM_BYTES
    return (1e3 * max(t_ops, t_bytes) / calls,
            "operations" if t_ops >= t_bytes else "bytes")


def smooth_clip(rng, depth, size, n_terms=6) -> np.ndarray:
    """A random smooth 3D field in [0, 1]: sums of separable sin/cos terms.
    size: the frame's side, or its (H, W)."""
    H, W = (size, size) if np.isscalar(size) else size
    t, y, x = np.meshgrid(*(np.linspace(-np.pi, np.pi, n) for n in (depth, H, W)),
                          indexing="ij")
    field = np.zeros_like(t)
    for _ in range(n_terms):
        a, b, c = rng.uniform(0.5, 3.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        field += rng.uniform(0.3, 1.0) * np.sin(a * x + ph[0]) * np.cos(b * y + ph[1]) \
            * np.cos(c * t + ph[2])
    return ((field - field.min()) / (field.max() - field.min())).astype(np.float32)


def psnr(x, ref) -> float:
    return float(10 * np.log10(1.0 / np.mean((x - ref) ** 2)))


def compare(name, what, got, ref, err) -> None:
    """Hold a kernel's output(s) against its plain version's."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for i, (g, r) in enumerate(zip(got, ref)):
        d, rel = rel_err(g, r)
        print(f"parity {name} [{what}] out {i}: max|d| {d:.3e}, rel {rel:.3e}", flush=True)
        require(rel <= KERNEL_TOL, f"{name} [{what}] rel err {rel:.3e} > {KERNEL_TOL}")
        err[name] = max(err.get(name, 0.0), d)


def noisy_images(rng, shape, sigmas, C=1):
    """(clean, noisy) stacks (len(sigmas), C, H, W) of smooth images, each
    channel a smooth_clip of depth 1, with AWGN at each image's sigma."""
    clean = np.stack([np.stack([smooth_clip(rng, 1, shape)[0] for _ in range(C)])
                      for _ in sigmas])
    sig = np.asarray(sigmas, np.float32).reshape(-1, 1, 1, 1)
    return clean, clean + sig / 255 * rng.standard_normal(clean.shape).astype(np.float32)


def random_2d_model(cfg, dev, cls=CDLNet):
    """A power-method CDLNet (or GDLNet; backend "pallas") with random
    thresholds > 0, so the soft threshold is exercised (the init's t0 is
    0)."""
    model = cls(**cfg, backend="pallas").to(dev).init(torch.Generator().manual_seed(SEED))
    tg = torch.Generator().manual_seed(SEED + 2)
    with torch.no_grad():
        model.t.copy_(torch.rand(model.t.shape, generator=tg)
                      * torch.tensor([0.02, 0.2]).reshape(1, 2, 1, 1, 1))
    return model


def serve_2d(dev, card, err) -> tuple[dict, dict]:
    """The 2D image serve path: kernel parity, K-iteration forwards, the
    flagship demo through Denoiser (launches counted), the other demos,
    and times. Returns (launches of the flagship serve run, the kernels'
    times at the served 128^2 image)."""
    rng = np.random.default_rng(SEED + 10)  # the 3D phases keep their draws
    # --- 2D-1. each 2D kernel against its plain version ---
    t0 = time.perf_counter()
    flag = random_2d_model(FLAGSHIP_2D, dev)
    jdd_p = random_2d_model(JDD_PARITY, dev)
    with torch.inference_mode():
        for label, model, shape in (("flagship 128^2", flag, IMAGE),
                                    ("flagship 320x480", flag, (320, 480)),
                                    ("jdd 128^2 masked", jdd_p, IMAGE)):
            s, C = model.s, model.C
            _, noisy = noisy_images(rng, shape, [SIGMA], C)
            y = torch.from_numpy(noisy).to(dev)
            mask = gen_bayer_mask(y) if C == 3 else None
            yp, _, mask = pre_process(y if mask is None else mask * y, s, mask=mask)
            y2, m2, wa, ws, tau, geom = L2.phase_operands(yp, model.A, model.B, model.t,
                                                          SIGMA / 255, s, mask)
            if m2 is None:  # a random observation mask for the masked residual
                m2 = (torch.rand(y2.shape, generator=torch.Generator().manual_seed(SEED))
                      > 0.3).float().to(dev)
            z0 = L2.lista2d_ana_threshold_plain(-y2, None, wa[0], tau[0], geom)
            r1 = L2.lista2d_syn_residual_plain(z0, ws[1], geom, mask=m2, y=y2)
            for name, what, run in (
                ("lista2d_ana_threshold", "k=0 (r=-y2, z=0)",
                 lambda f: f(-y2, None, wa[0], tau[0], geom)),
                ("lista2d_ana_threshold", "k=1", lambda f: f(r1, z0, wa[1], tau[1], geom)),
                ("lista2d_syn_residual", "residual B1 z - y",
                 lambda f: f(z0, ws[1], geom, y=y2)),
                ("lista2d_syn_residual", "masked residual",
                 lambda f: f(z0, ws[2], geom, mask=m2, y=y2)),
                ("lista2d_syn_residual", "final B0 z", lambda f: f(z0, ws[0], geom)),
            ):
                got = run(getattr(L2, name))
                ref = run(getattr(L2, name + "_plain"))
                torch.cuda.synchronize()
                compare(name, f"{label} {what}", got, ref, err)

        # --- 2D-2. the K-iteration forward on the kernels vs the plain loop ---
        jdd = random_2d_model(JDD_2D, dev)
        for label, model, shape in (("2d-flagship eval 128^2", flag, IMAGE),
                                    ("2d-flagship eval 512^2", flag, (512, 512)),
                                    ("2d-flagship eval 320x480", flag, (320, 480)),
                                    ("jdd eval 128^2 masked", jdd, IMAGE)):
            _, noisy = noisy_images(rng, shape, [SIGMA], model.C)
            y = torch.from_numpy(noisy).to(dev)
            mask = gen_bayer_mask(y) if model.C == 3 else None
            yp, _, mask = pre_process(y if mask is None else mask * y, model.s, mask=mask)
            c = SIGMA / 255
            x_k, z_k = L2.lista2d_fused(yp, model.A, model.B, model.t, c, stride=model.s,
                                        mask=mask, return_z=True)
            z_p = lista_2d(yp, model.A, model.B, model.t, c, mask=mask, stride=model.s)
            x_p = conv_transpose2d(z_p, model.B[0], stride=model.s, padding=model.pad,
                                   output_padding=model.s - 1)
            torch.cuda.synchronize()
            for what, got, ref in (("x", x_k, x_p), ("z", z_k, z_p)):
                d, rel = rel_err(got, ref)
                print(f"parity {label} (K={model.K}) forward {what}: max|d| {d:.3e}, "
                      f"rel {rel:.3e}", flush=True)
                require(rel <= FORWARD_TOL, f"{label} forward {what} rel err {rel:.3e}")
        del jdd, jdd_p, x_k, z_k, z_p, x_p
    print(f"serve 2D: parity phases in {time.perf_counter() - t0:.2f} s", flush=True)

    # --- 2D-3. the trained flagship demo through Denoiser (the serve path) ---
    server = Denoiser.from_dir(DEMO_2D)
    server_xla = Denoiser.from_dir(DEMO_2D, backend="xla")
    require(server.device.type == "cuda", "Denoiser.from_dir did not default to the card")
    K = server.model.K
    images = [noisy_images(rng, IMAGE, [SIGMA]) for _ in range(3)]
    images.append(noisy_images(rng, BIG_IMAGE, [SIGMA]))
    images = [(c[0, 0], n[0, 0]) for c, n in images]
    batch_clean, batch_noisy = noisy_images(rng, IMAGE, BATCH_SIGMAS)
    L.launches.clear()
    outs = [server.denoise_image(n, sigma=SIGMA) for _, n in images]
    blind = server.denoise_image(images[0][1])
    batch = server.denoise_image_batch(batch_noisy, sigmas=BATCH_SIGMAS)
    launches = dict(L.launches)
    forwards = len(images) + 2
    print(f"serve 2D: {len(images)} flagship images + 1 blind + a batch of "
          f"{len(BATCH_SIGMAS)}, launches {launches}", flush=True)
    require(launches == {"lista2d_ana_threshold": forwards * K,
                         "lista2d_syn_residual": forwards * K},
            f"expected {K} + {K} launches per forward ({forwards} forwards), got {launches}")
    gains = [psnr(o, c) - psnr(n, c) for o, (c, n) in zip(outs, images)]
    gains.append(psnr(blind, images[0][0]) - psnr(images[0][1], images[0][0]))
    gains += [psnr(o, c) - psnr(n, c) for o, c, n in zip(batch, batch_clean, batch_noisy)]
    d_xla = max(
        [float(np.abs(o - server_xla.denoise_image(n, sigma=SIGMA)).max())
         for o, (_, n) in zip(outs, images)]
        + [float(np.abs(blind - server_xla.denoise_image(images[0][1])).max()),
           float(np.abs(batch - server_xla.denoise_image_batch(
               batch_noisy, sigmas=BATCH_SIGMAS)).max())])
    print(f"serve 2D: PSNR gains (dB) known sigma {[f'{g:.3f}' for g in gains[:4]]}, "
          f"blind {gains[4]:.3f}, batch {[f'{g:.3f}' for g in gains[5:]]}; kernels vs "
          f"backend xla max|d| {d_xla:.3e}", flush=True)
    require(all(np.isfinite(o).all() for o in outs + [blind, batch]), "non-finite output")
    require(outs[3].shape == BIG_IMAGE, f"misshapen output {outs[3].shape}")
    require(min(gains) >= MIN_GAIN_DB, f"PSNR gain {min(gains):.3f} dB < {MIN_GAIN_DB}")
    require(d_xla <= 1e-4, f"kernels vs backend xla max|d| {d_xla:.3e} > 1e-4")

    # --- 2D-4. the other demos on the kernels and on backend "xla" ---
    for demo in ("jdd-demo", "gdlnet-demo", "cdlnet-demo"):
        path = os.path.join(EXAMPLES, demo)
        d, d_plain = Denoiser.from_dir(path), Denoiser.from_dir(path, backend="xla")
        if demo == "jdd-demo":  # a mosaicked colour image: the model takes the mask
            _, noisy = noisy_images(rng, IMAGE, [10.0], C=3)
            y = torch.from_numpy(noisy).to(dev)
            mask = gen_bayer_mask(y)
            with torch.inference_mode():
                out, ref = (m.model(mask * y, 10.0, mask=mask)[0].cpu().numpy()
                            for m in (d, d_plain))
        else:
            _, noisy = noisy_images(rng, IMAGE, [SIGMA])
            out, ref = (m.denoise_image(noisy[0, 0], sigma=SIGMA) for m in (d, d_plain))
        dd = float(np.abs(out - ref).max())
        print(f"demo 2D {demo}: kernels vs backend xla max|d| {dd:.3e}", flush=True)
        require(np.isfinite(out).all() and dd <= 1e-4,
                f"{demo}: kernels vs xla max|d| {dd:.3e} (or non-finite)")

    # --- 2D-5. times (CUDA events, median of 5) ---
    times = {}
    with torch.inference_mode():
        for label, shape in (("128^2", IMAGE), ("512^2", (512, 512))):
            _, noisy = noisy_images(rng, shape, [SIGMA])
            yp, _, _ = pre_process(torch.from_numpy(noisy).to(dev), flag.s)
            y2, _, wa, ws, tau, geom = L2.phase_operands(yp, flag.A, flag.B, flag.t,
                                                          SIGMA / 255, flag.s)
            z0 = L2.lista2d_ana_threshold(-y2, None, wa[0], tau[0], geom)
            r1 = L2.lista2d_syn_residual(z0, ws[1], geom, y=y2)
            r_full = pp.depth_to_space(r1, flag.s, 2, 1)
            n_pos = y2[:, 0].numel()
            tt = {}
            for name, run, plain, lib, bank, io in (
                ("lista2d_ana_threshold",
                 lambda: L2.lista2d_ana_threshold(r1, z0, wa[1], tau[1], geom),
                 lambda: L2.lista2d_ana_threshold_plain(r1, z0, wa[1], tau[1], geom),
                 lambda: F.conv2d(r_full, flag.A[1], stride=flag.s, padding=flag.pad),
                 wa[1], (r1, z0, wa[1], tau[1], z0)),
                ("lista2d_syn_residual",
                 lambda: L2.lista2d_syn_residual(z0, ws[1], geom, y=y2),
                 lambda: L2.lista2d_syn_residual_plain(z0, ws[1], geom, y=y2),
                 lambda: F.conv_transpose2d(z0, flag.B[1], stride=flag.s, padding=flag.pad,
                                            output_padding=flag.s - 1),
                 ws[1], (z0, ws[1], y2, r1)),  # reads y, writes r (y's size)
            ):
                tt[name] = dict(zip(("ms", "plain_ms", "library_ms"),
                                    (cuda_ms(f, 20) for f in (run, plain, lib))))
                tt[name]["bound_ms"], tt[name]["bound_by"] = bound((bank,), n_pos, io,
                                                                   tf32x3=True)
                print(f"time [{card}]: 2D flagship {label} {name}: {tt[name]['ms']:.4f} "
                      f"ms/call, plain {tt[name]['plain_ms']:.4f}, library "
                      f"{tt[name]['library_ms']:.4f}, bound {tt[name]['bound_ms']:.4f} "
                      f"({tt[name]['bound_by']}); {K} launches per image", flush=True)
            if shape == IMAGE:
                times = tt  # the served image size goes into the kernel table
                (N, Cp, Hc, Wc), M, (Qh, Qw) = y2.shape, wa.shape[-1], wa.shape[2:4]
                grids = {"lista2d_ana_threshold": L2.launch_grid(False, N, Cp, M, Hc, Wc, Qh, Qw),
                         "lista2d_syn_residual": L2.launch_grid(True, N, M, Cp, Hc, Wc, Qh, Qw)}
                for name, gr in grids.items():
                    print(f"grid [{card}]: 2D flagship {label} {name}: {gr}", flush=True)
        xla_model = server_xla.model
        for label, shape in (("128^2", IMAGE), ("481x321", BIG_IMAGE)):
            _, noisy = noisy_images(rng, shape, [SIGMA])
            # the forward at the bucket shape denoise_image runs
            bucketed = np.pad(noisy, [(0, 0), (0, 0)] + [(0, -n % server.bucket)
                                                         for n in shape], mode="reflect")
            yt = torch.from_numpy(bucketed).to(dev)
            fwd = cuda_ms(lambda: server.model(yt, SIGMA), reps=3)
            fwd_xla = cuda_ms(lambda: xla_model(yt, SIGMA), reps=3)
            lat = host_ms(lambda: server.denoise_image(noisy[0, 0], sigma=SIGMA))
            lat_xla = host_ms(lambda: server_xla.denoise_image(noisy[0, 0], sigma=SIGMA))
            print(f"time [{card}]: flagship 2D image {label} (bucket {yt.shape[2]}x"
                  f"{yt.shape[3]}): forward {fwd:.3f} ms on the "
                  f"kernels, {fwd_xla:.3f} ms on backend xla; Denoiser.denoise_image "
                  f"{lat:.3f} ms (kernels), {lat_xla:.3f} ms (xla), host clock", flush=True)
    _, batch8 = noisy_images(rng, IMAGE, [SIGMA] * THROUGHPUT_BATCH)
    for label, srv in (("kernels", server), ("xla", server_xla)):
        ms = host_ms(lambda: srv.denoise_image_batch(batch8, sigmas=SIGMA))
        print(f"time [{card}]: flagship 2D denoise_image_batch of {THROUGHPUT_BATCH} at "
              f"128^2 on the {label}: {ms:.3f} ms, {1e3 * THROUGHPUT_BATCH / ms:.1f} "
              f"images/s", flush=True)
    return launches, times


def natural_crops(rng, n, size, C=1) -> np.ndarray:
    """(n, C, size, size) random crops of data/synthetic.natural_image
    images 52 pixels wider (the reference's 180^2 images for 128^2 crops),
    one image per crop and channel."""
    out = np.empty((n, C, size, size), np.float32)
    for i in range(n):
        for c in range(C):
            y, x = rng.integers(0, 53, 2)
            out[i, c] = natural_image(rng, size=size + 52)[y:y + size, x:x + size]
    return out


def observed(rng, clean, dev, mask=None):
    """(noisy observation, sigma (N, 1, 1, 1)) on dev of the clean numpy
    batch: AWGN at a sigma per image uniform in TRAIN_SIGMA, through the
    mask (on dev) when given."""
    sig = rng.uniform(*TRAIN_SIGMA, (clean.shape[0], 1, 1, 1)).astype(np.float32)
    noisy = clean + sig / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    noisy, sig = (torch.from_numpy(a).to(dev) for a in (noisy, sig))
    return (noisy if mask is None else mask * noisy), sig


def step_launches_2d(K) -> dict:
    """Launches of one 2D training step of K iterations: forward K + K,
    reverse K syn_adjoint, K-1 syn_residual (the analysis adjoint) and 2K
    wgrad (dA and dB)."""
    return {"lista2d_ana_threshold": K, "lista2d_syn_residual": 2 * K - 1,
            "lista2d_syn_adjoint": K, "lista2d_wgrad": 2 * K}


def train_2d(dev, card, err) -> tuple[dict, dict]:
    """The 2D image training path: reverse kernel parity, the gradients
    through the kernels vs backend "xla", fit(workload="2d"), times, and
    the train CLI. Returns (launches of the fit and CLI runs, the reverse
    kernels' times at the flagship training shape)."""
    rng = np.random.default_rng(SEED + 20)  # the earlier phases keep their draws
    flag = random_2d_model(FLAGSHIP_2D, dev)
    clean = natural_crops(rng, TRAIN_2D_N, CROP)
    clean_t = torch.from_numpy(clean).to(dev)
    noisy_t, sig_t = observed(rng, clean, dev)
    K = flag.K

    # --- T2-1. each reverse kernel against its plain version ---
    t0 = time.perf_counter()
    color_s2 = random_2d_model(COLOR_S2_2D, dev)
    jdd = random_2d_model(JDD_2D, dev)
    flag_ops = None
    with torch.no_grad():
        for label, model, n in ((f"flagship {TRAIN_2D_N}x{CROP}^2", flag, TRAIN_2D_N),
                                (f"jdd 2x{CROP}^2 masked", jdd, 2),
                                (f"C=3 s=2 2x{CROP}^2 masked", color_s2, 2)):
            s, C, Km = model.s, model.C, model.K
            if model is flag:
                y, sig, mask = noisy_t, sig_t, None
            else:
                cl = natural_crops(rng, n, CROP, C)
                mask = gen_bayer_mask(torch.from_numpy(cl)).to(dev)
                y, sig = observed(rng, cl, dev, mask)
            yp, _, mask = pre_process(y, s, mask=mask)
            y2, m2, wa, ws, tau, geom = L2.phase_operands(yp, model.A, model.B, model.t,
                                                          sig / 255, s, mask)
            _, _, (zh, rh) = L2.lista2d_loop(y2, m2, wa, ws, tau, geom, return_hists=True)
            wa_adj, ws_adj = LB.adjoint_bank(wa, 2), LB.adjoint_bank(ws, 2)
            taps = tuple(wa.shape[2:4])
            if m2 is None:  # a random observation mask for the masked adjoint
                m2 = (torch.rand(y2.shape, generator=torch.Generator().manual_seed(SEED))
                      > 0.3).float().to(dev)
            dx2 = torch.randn(y2.shape, generator=torch.Generator().manual_seed(SEED)).to(dev)
            k = Km // 2
            dv, _ = LB2.lista2d_syn_adjoint_plain(dx2, ws_adj[0], zh[Km - 1], geom)
            g = L2.lista2d_syn_residual_plain(dv, wa_adj[k], geom, mask=m2)
            rows = LB.phase_rows(geom, wa.shape[1], 2)  # as the reverse loop passes them
            for name, what, mod, run in (
                ("lista2d_syn_adjoint", "init dz = B0*(dx2)", LB2,
                 lambda f: f(dx2, ws_adj[0], zh[Km - 1], geom)),
                ("lista2d_syn_adjoint", f"k={k} dz = dv - Bk*(g)", LB2,
                 lambda f: f(g, ws_adj[k], zh[k - 1], geom, base=dv, alpha=-1.0)),
                ("lista2d_wgrad", "dA = -dv (*) r", LB2,
                 lambda f: f(rh[k - 1], dv, taps, geom.off_a, alpha=-1.0)),
                ("lista2d_wgrad", "dB = adjoint of -z (*) g", LB2,
                 lambda f: f(g, zh[k - 1], taps, geom.off_a, alpha=-1.0)),
                ("lista2d_wgrad", "dA masked", LB2,
                 lambda f: f(rh[k - 1], dv, taps, geom.off_a, alpha=-1.0, rows=rows)),
                ("lista2d_wgrad", "dB masked", LB2,
                 lambda f: f(g, zh[k - 1], taps, geom.off_a, alpha=-1.0, rows=rows)),
                ("lista2d_syn_residual", "A-adjoint g = m * Ak*(dv)", L2,
                 lambda f: f(dv, wa_adj[k], geom, mask=m2)),
            ):
                got = run(getattr(mod, name))
                ref = run(getattr(mod, name + "_plain"))
                torch.cuda.synchronize()
                compare(name, f"{label} {what}", got, ref, err)
            if model is flag:  # kept for the times
                flag_ops = dict(y2=y2, wa=wa, ws=ws, tau=tau, geom=geom, zh=zh, rh=rh,
                                wa_adj=wa_adj, ws_adj=ws_adj, taps=taps, m2=m2, dv=dv,
                                g=g, k=k, rows=rows)
            del zh, rh
    print(f"train 2D: reverse kernel parity in {time.perf_counter() - t0:.2f} s", flush=True)

    # --- T2-2. the gradients through the kernels vs torch autograd ("xla") ---
    gdl = random_2d_model(GDLNET_2D, dev, cls=GDLNet)
    jdd_clean = natural_crops(rng, 2, CROP, 3)
    jdd_mask = gen_bayer_mask(torch.from_numpy(jdd_clean)).to(dev)
    for label, model, cl, mask in (
        (f"2d-flagship train {TRAIN_2D_N}x{CROP}^2", flag, clean, None),
        (f"2d-flagship train 1x{BIG_CROP}^2", flag, natural_crops(rng, 1, BIG_CROP), None),
        (f"jdd (K={jdd.K}) train 2x{CROP}^2 masked", jdd, jdd_clean, jdd_mask),
        (f"gdlnet (K={gdl.K}) train 2x{CROP}^2", gdl, natural_crops(rng, 2, CROP), None),
    ):
        obs, sig = (noisy_t, sig_t) if cl is clean else observed(rng, cl, dev, mask)
        cl = torch.from_numpy(cl).to(dev)
        plain = copy.deepcopy(model)
        plain.backend = "xla"
        names = [n for n, _ in model.named_parameters()
                 if n not in getattr(model, "unused_params", ())]

        def grads(m):
            loss = mse_loss(m(obs, sig, mask=mask)[0], cl)
            prm = dict(m.named_parameters())
            return torch.autograd.grad(loss, [prm[n] for n in names])

        L.launches.clear()
        g1 = grads(model)
        torch.cuda.synchronize()
        want = step_launches_2d(model.K)
        require(dict(L.launches) == want,
                f"{label}: one gradient launched {dict(L.launches)}, expected {want}")
        g2 = grads(model)
        gp = grads(plain)
        torch.cuda.synchronize()
        for name, a, b, ref in zip(names, g1, g2, gp):
            d, rel = rel_err(a, ref)
            print(f"parity {label} gradient d{name}: max|d| {d:.3e}, rel {rel:.3e}; two runs "
                  f"bitwise equal: {torch.equal(a, b)}", flush=True)
            require(rel <= GRAD_TOL, f"{label} gradient d{name} rel err {rel:.3e} > {GRAD_TOL}")
            require(torch.equal(a, b), f"{label}: two backward runs differ in d{name}")
        del plain, g1, g2, gp
    del gdl, jdd, color_s2

    # --- T2-3. fit(workload="2d"): FIT_STEPS steps at the flagship width ---
    fit_model = CDLNet(**FLAGSHIP_2D, backend="pallas").to(dev).init(
        torch.Generator().manual_seed(SEED))
    opt = make_optimizer(FIT_2D_LR, clip_grad=FIT_2D_CLIP)
    state = opt.init(dict(fit_model.named_parameters()))
    loaders = {"train": [clean], "val": [clean], "test": [clean]}  # one batch a pass
    with tempfile.TemporaryDirectory() as save_dir:
        L.launches.clear()
        t0 = time.perf_counter()
        state, history = fit(fit_model, opt, state, loaders, save_dir=save_dir,
                             epochs=FIT_STEPS, noise_std=TRAIN_SIGMA, val_freq=10,
                             save_freq=10, backtrack_thresh=None, verbose=False,
                             seed=SEED, workload="2d")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(L.launches)
        evals = sum(ph != "train" for _, ph, _ in history)
        want = {name: FIT_STEPS * n for name, n in step_launches_2d(K).items()}
        want["lista2d_ana_threshold"] += evals * K
        want["lista2d_syn_residual"] += evals * K
        losses = [10 ** (-p / 10) for _, ph, p in history if ph == "train"]
        print(f"fit 2D: {FIT_STEPS} steps of {TRAIN_2D_N}x{CROP}^2 (lr {FIT_2D_LR}, clip "
              f"{FIT_2D_CLIP}) + {evals} evals in {fit_s:.2f} s; launches {fit_launches}; "
              f"train losses {[f'{v:.6f}' for v in losses]}", flush=True)
        require(fit_launches == want, f"fit 2D launched {fit_launches}, expected {want}")
        require(len(losses) == FIT_STEPS and all(np.isfinite(losses)),
                f"non-finite or missing 2D train losses {losses}")
        require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                f"2D losses did not fall: first 5 {losses[:5]}, last 5 {losses[-5:]}")
        back = CDLNet(**FLAGSHIP_2D).to(dev)
        back_state = opt.init(dict(back.named_parameters()))
        _, back_state, epoch, _ = load_ckpt(os.path.join(save_dir, "net.ckpt.npz"),
                                            back, back_state)
        require(epoch == FIT_STEPS and back_state["count"] == FIT_STEPS
                and all(torch.equal(a, b) for a, b in
                        zip(back.parameters(), fit_model.parameters())),
                "fit 2D's checkpoint did not reload to the trained state")
    del back, back_state, fit_model

    # --- T2-4. times at the flagship training shape (CUDA events, median of 5):
    # each kernel, its plain version, the one PyTorch call of the same
    # function, and the bound; wgrad runs as each reverse step does, dA then
    # dB, masked, and reports per call ("lista2d_wgrad dense": every phase
    # row) ---
    o = flag_ops
    k, geom, taps, s, pad, rows = o["k"], o["geom"], o["taps"], flag.s, flag.pad, o["rows"]
    zh, rh, dv, g, wa_adj, ws_adj = (o[n] for n in ("zh", "rh", "dv", "g", "wa_adj", "ws_adj"))
    wa, ws, tau, y2, m2 = (o[n] for n in ("wa", "ws", "tau", "y2", "m2"))
    n_pos = y2[:, 0].numel()
    times = {}
    with torch.no_grad():
        g_full = pp.depth_to_space(g, s, 2, 1)
        r_full = pp.depth_to_space(rh[k - 1], s, 2, 1)
        wg = torch.nn.grad.conv2d_weight

        def pair(f, lib=False, kw=None):
            if lib:
                return lambda: (wg(r_full, flag.A[k].shape, dv, stride=s, padding=pad),
                                wg(g_full, flag.B[k].shape, zh[k - 1], stride=s, padding=pad))
            kw = {"rows": rows} if kw is None else kw
            return lambda: (f(rh[k - 1], dv, taps, geom.off_a, alpha=-1.0, **kw),
                            f(g, zh[k - 1], taps, geom.off_a, alpha=-1.0, **kw))

        for name, what, run, plain, lib, banks, io in (
            ("lista2d_syn_adjoint", "",
             lambda: LB2.lista2d_syn_adjoint(g, ws_adj[k], zh[k - 1], geom, base=dv, alpha=-1.0),
             lambda: LB2.lista2d_syn_adjoint_plain(g, ws_adj[k], zh[k - 1], geom, base=dv,
                                                   alpha=-1.0),
             lambda: F.conv2d(g_full, flag.B[k], stride=s, padding=pad),
             (ws_adj[k],), (g, ws_adj[k], dv, zh[k - 1], dv, tau[0])),
            ("lista2d_wgrad", "",  # dA = -dv (*) r, then dB = -g (*) z
             pair(LB2.lista2d_wgrad), pair(LB2.lista2d_wgrad_plain), pair(None, lib=True),
             (wa[k], ws[k]), (rh[k - 1], dv, wa[k], g, zh[k - 1], ws[k])),
            ("lista2d_wgrad", " dense",
             pair(LB2.lista2d_wgrad, kw={}), pair(LB2.lista2d_wgrad_plain, kw={}),
             pair(None, lib=True), (torch.ones_like(wa[k]), torch.ones_like(ws[k])),
             (rh[k - 1], dv, wa[k], g, zh[k - 1], ws[k])),
            ("lista2d_ana_threshold", " train",
             lambda: L2.lista2d_ana_threshold(rh[k - 1], zh[k - 1], wa[k], tau[k], geom),
             lambda: L2.lista2d_ana_threshold_plain(rh[k - 1], zh[k - 1], wa[k], tau[k], geom),
             lambda: F.conv2d(r_full, flag.A[k], stride=s, padding=pad),
             (wa[k],), (rh[k - 1], zh[k - 1], wa[k], tau[k], zh[k])),
            ("lista2d_syn_residual", " train",
             lambda: L2.lista2d_syn_residual(zh[k - 1], ws[k], geom, y=y2),
             lambda: L2.lista2d_syn_residual_plain(zh[k - 1], ws[k], geom, y=y2),
             lambda: F.conv_transpose2d(zh[k - 1], flag.B[k], stride=s, padding=pad,
                                        output_padding=s - 1),
             (ws[k],), (zh[k - 1], ws[k], y2, y2)),  # reads y, writes r (y's size)
            ("lista2d_syn_residual", " A-adjoint",
             lambda: L2.lista2d_syn_residual(dv, wa_adj[k], geom, mask=m2),
             lambda: L2.lista2d_syn_residual_plain(dv, wa_adj[k], geom, mask=m2),
             lambda: F.conv_transpose2d(dv, flag.A[k], stride=s, padding=pad,
                                        output_padding=s - 1),
             (wa_adj[k],), (dv, wa_adj[k], m2, y2)),
        ):
            calls = len(banks)
            tt = dict(zip(("ms", "plain_ms", "library_ms"),
                          (cuda_ms(f, 10) / calls for f in (run, plain, lib))))
            tt["bound_ms"], tt["bound_by"] = bound(banks, n_pos, io, calls,
                                                   tf32x3=name in TC_KERNELS)
            times[name + what] = tt
            print(f"time [{card}]: 2D train shape ({TRAIN_2D_N}x{CROP}^2) {name + what}: "
                  f"{tt['ms']:.4f} ms/call, plain {tt['plain_ms']:.4f}, library "
                  f"{tt['library_ms']:.4f}, bound {tt['bound_ms']:.4f} ({tt['bound_by']}); "
                  f"{step_launches_2d(K).get(name, 0)} launches of {name} per step", flush=True)
        N, Cp, Hc, Wc = y2.shape
        M = wa.shape[-1]
        print(f"grid [{card}]: 2D train shape ({TRAIN_2D_N}x{CROP}^2) lista2d_wgrad (row "
              f"blocks, code blocks, splits) masked {LB.wgrad_grid(N, Cp, M, (Hc, Wc), taps, rows)}"
              f", dense {LB.wgrad_grid(N, Cp, M, (Hc, Wc), taps)}; lista2d_syn_adjoint "
              f"{L2.launch_grid(False, N, Cp, M, Hc, Wc, *taps)}", flush=True)
        del g_full, r_full
    del flag_ops, o, zh, rh, dv, g

    # --- T2-5. the 2D train step: kernels vs backend "xla" (host clock) ---
    plain_flag = copy.deepcopy(flag)
    plain_flag.backend = "xla"
    step_ms = {}
    for label, m in (("kernels", flag), ("xla", plain_flag)):
        st = opt.init(dict(m.named_parameters()))
        torch.cuda.reset_peak_memory_stats()
        step_ms[label] = host_ms(lambda: train_update(m, opt, st, noisy_t, sig_t, clean_t))
        step_ms[label + " peak GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"time [{card}]: flagship 2D train step (N={TRAIN_2D_N}, {CROP}^2, fwd + bwd + "
          f"Adam + project) {step_ms['kernels']:.3f} ms on the kernels "
          f"(peak {step_ms['kernels peak GB']:.2f} GB), {step_ms['xla']:.3f} ms on "
          f"backend xla (peak {step_ms['xla peak GB']:.2f} GB)", flush=True)
    del flag, plain_flag

    # --- T2-6. the train CLI (cli.train.main with no device: the card) on
    # image directories, with the flagship demo's config ---
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = gen_natural_image_dirs(os.path.join(root, "data"), n_train=CLI_TRAIN_IMAGES,
                                      n_test=CLI_TEST_IMAGES, seed=SEED)
        gen_s = time.perf_counter() - t0
        with open(os.path.join(DEMO_2D, "args.json")) as f:
            args = json.load(f)
        save_dir = os.path.join(root, "run")
        args["paths"] = {"save": save_dir}  # no ckpt: the power-method init
        args["train"]["fit"].update(epochs=CLI_EPOCHS, val_freq=1, save_freq=1,
                                    backtrack_thresh=None, verbose=False)
        args["train"]["loaders"].update(
            {f"{k}_path_list": [os.path.join(data, split)]
             for k, split in (("trn", "train"), ("val", "val"), ("tst", "test"))})
        # the loader's host time per training batch (crops, flips, stacking)
        loaders, _ = cli_train.make_loaders(args)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loaders["train"])
        loader_ms = 1e3 * (time.perf_counter() - t0) / n_batches
        L.launches.clear()
        t0 = time.perf_counter()
        cli_state, history = cli_train.main(args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = dict(L.launches)
        n_steps = CLI_EPOCHS * len(loaders["train"])
        evals = CLI_EPOCHS * len(loaders["val"]) + len(loaders["test"])
        want = {name: n_steps * n for name, n in step_launches_2d(K).items()}
        want["lista2d_ana_threshold"] += evals * K
        want["lista2d_syn_residual"] += evals * K
        print(f"cli 2D: {data} written in {gen_s:.2f} s; cli.train.main ran {n_steps} steps "
              f"of {TRAIN_2D_N}x{CROP}^2 + {evals} eval images in {cli_s:.2f} s; launches "
              f"{cli_launches}; PSNR {[(e, ph, round(p, 3)) for e, ph, p in history]}", flush=True)
        print(f"time [{card}]: image loader {loader_ms:.3f} ms per training batch of "
              f"{TRAIN_2D_N}x{CROP}^2 (host clock) beside the 2D train step "
              f"{step_ms['kernels']:.3f} ms on the kernels", flush=True)
        require(cli_launches == want, f"the train CLI launched {cli_launches}, expected {want}")
        require([(e, ph) for e, ph, _ in history]
                == [(1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]
                and all(np.isfinite(p) for _, _, p in history),
                f"the train CLI's history {history}")
        require(os.path.isfile(os.path.join(save_dir, "net.ckpt.npz"))
                and os.path.isfile(os.path.join(save_dir, "args.json")),
                f"the train CLI saved {sorted(os.listdir(save_dir))}")
        with open(os.path.join(save_dir, "args.json")) as f:
            saved = json.load(f)
        back, _, back_state, epoch0, _ = init_model(saved)
        require(saved["paths"]["ckpt"] == os.path.join(save_dir, "net.ckpt.npz")
                and back.A.device.type == "cuda" and epoch0 == CLI_EPOCHS
                and back_state["count"] == cli_state["count"] == n_steps
                and all(torch.isfinite(p).all() for p in back.parameters()),
                "the train CLI's checkpoint did not reload through its args.json")
        del back, back_state, cli_state
    launches = {name: fit_launches.get(name, 0) + cli_launches.get(name, 0)
                for name in set(fit_launches) | set(cli_launches)}
    return launches, {n: times[n] for n in ("lista2d_syn_adjoint", "lista2d_wgrad")}


def forward_parity(A, B, t, yp, s, c, tg, err, what="") -> dict:
    """The forward kernels against their plain versions on one clip's phase
    operands: the analysis at k = 0 (r = -y2, z = 0) and k = 1, the residual
    with and without a mask, the final synthesis. Returns the operands, for
    the timings."""
    P = tuple(int(p) for p in A.shape[-3:])
    pads = tuple(p // 2 for p in P)
    geom = L.Geom(s, P, pads)
    wa = L.prep_A2m_3d(A, s, pads)
    ws = L.prep_B2m_3d(B, s, pads)
    y2 = pp.space_to_depth(yp, s, 3).contiguous()
    tau = (t[:, 0, :, 0, 0, 0] + c * t[:, 1, :, 0, 0, 0])[:, None].contiguous()
    mask2 = (torch.rand(y2.shape, generator=tg) > 0.3).float().to(y2.device)
    z0 = L.lista3d_ana_threshold_plain(-y2, None, wa[0], tau[0], geom)
    r1 = L.lista3d_syn_residual_plain(z0, ws[1], geom, y=y2)
    cases = [
        ("lista3d_ana_threshold", "k=0 (r=-y2, z=0)",
         lambda f: f(-y2, None, wa[0], tau[0], geom)),
        ("lista3d_ana_threshold", "k=1", lambda f: f(r1, z0, wa[1], tau[1], geom)),
        ("lista3d_syn_residual", "residual B1 z - y", lambda f: f(z0, ws[1], geom, y=y2)),
        ("lista3d_syn_residual", "masked residual",
         lambda f: f(z0, ws[2], geom, mask=mask2, y=y2)),
        ("lista3d_syn_residual", "final B0 z", lambda f: f(z0, ws[0], geom)),
    ]
    for name, case, run in cases:
        got = run(getattr(L, name))
        ref = run(getattr(L, name + "_plain"))
        torch.cuda.synchronize()
        compare(name, what + case, got, ref, err)
        del got, ref
    return dict(geom=geom, wa=wa, ws=ws, y2=y2, tau=tau, z0=z0)


def k_forward_parity(A, B, t, yp, s, c, what, time_it=False):
    """The K-iteration forward on the kernels (lista3d_fused) against the
    plain loop (ops.lista.lista_3d and the final synthesis): x and z within
    FORWARD_TOL of max|ref|. With time_it, returns the device ms of each
    (CUDA events, median of 3)."""
    pads = tuple(int(p) // 2 for p in A.shape[-3:])

    def kernels():
        return L.lista3d_fused(yp, A, B, t, c, stride=s)

    def plain():
        z = lista_3d(yp, A, B, t, c, stride=s)
        return conv_transpose3d(z, B[0], stride=s, padding=pads, output_padding=s - 1), z

    got, ref = kernels(), plain()
    torch.cuda.synchronize()
    for name, a, b in zip("xz", got, ref):
        d, rel = rel_err(a, b)
        print(f"parity K={A.shape[0]} forward {what} {name}: max|d| {d:.3e}, rel {rel:.3e}",
              flush=True)
        require(rel <= FORWARD_TOL, f"K={A.shape[0]} forward {what} {name} rel err {rel:.3e}")
    del got, ref
    if time_it:
        return (cuda_ms(kernels, 1, rounds=3, warmup=1),
                cuda_ms(plain, 1, rounds=3, warmup=1))
    return None


def forward_times(A_k, B_k, ops, s, reps) -> dict:
    """Each forward kernel's ms per call (CUDA events, median of 5) at one
    clip's phase operands (forward_parity), with iteration k's banks A_k,
    B_k, beside its plain version, the one strided PyTorch call of the same
    function, and its bound."""
    geom, wa, ws, y2, z0, tau = (ops[n] for n in ("geom", "wa", "ws", "y2", "z0", "tau"))
    pads = geom.pads
    r = L.lista3d_syn_residual(z0, ws[1], geom, y=y2)
    r_full = pp.depth_to_space(r, s, 3, A_k.shape[1])
    n_pos = y2[:, 0].numel()
    times = {}
    for name, run, plain, lib, bank, io in (
        ("lista3d_ana_threshold",
         lambda: L.lista3d_ana_threshold(r, z0, wa[1], tau[1], geom),
         lambda: L.lista3d_ana_threshold_plain(r, z0, wa[1], tau[1], geom),
         lambda: F.conv3d(r_full, A_k, stride=s, padding=pads),
         wa[1], (r, z0, wa[1], tau[1], z0)),
        ("lista3d_syn_residual",
         lambda: L.lista3d_syn_residual(z0, ws[1], geom, y=y2),
         lambda: L.lista3d_syn_residual_plain(z0, ws[1], geom, y=y2),
         # the code grid is already the strided conv's output grid
         lambda: F.conv_transpose3d(z0, B_k, stride=s, padding=pads, output_padding=s - 1),
         ws[1], (z0, ws[1], y2, r)),
    ):
        times[name] = dict(zip(("ms", "plain_ms", "library_ms"),
                               (cuda_ms(f, reps) for f in (run, plain, lib))))
        times[name]["bound_ms"], times[name]["bound_by"] = bound((bank,), n_pos, io,
                                                                 tf32x3=True)
    return times


def reverse_parity(A, B, t, noisy, sig, s, tg, err, what="") -> dict:
    """The reverse kernels against their plain versions on one training
    batch's fp32 histories: the synthesis adjoint of the init and of a
    middle iteration k (with and without the negated correlation), both
    weight gradients and the analysis adjoint (kernels/lista3d_bwd.py's
    steps). Returns the operands, for the timings."""
    K = A.shape[0]
    yp, _, _ = pre_process_3d(noisy, s)
    y2, _, wa, ws, tau, geom = L.phase_operands(yp, A, B, t, sig / 255, s)
    x2, _, (zh, rh) = L.lista3d_loop(y2, None, wa, ws, tau, geom, return_hists=True)
    wa_adj, ws_adj = LB.adjoint_bank(wa), LB.adjoint_bank(ws)
    taps = tuple(wa.shape[2:5])
    mask = (torch.rand(y2.shape, generator=tg) > 0.3).float().to(y2.device)
    dx2 = torch.randn(x2.shape, generator=tg).to(y2.device)
    k = K // 2
    dv, _ = LB.lista3d_syn_adjoint_plain(dx2, ws_adj[0], zh[K - 1], geom)
    g = L.lista3d_syn_residual_plain(dv, wa_adj[k], geom, mask=mask)
    rows = LB.phase_rows(geom, wa.shape[1], 3)  # as the reverse loop passes them
    cases = [
        ("lista3d_syn_adjoint", "init dz = B0*(dx2)", LB,
         lambda f: f(dx2, ws_adj[0], zh[K - 1], geom)),
        ("lista3d_syn_adjoint", f"k={k} dz = dv - Bk*(g)", LB,
         lambda f: f(g, ws_adj[k], zh[k - 1], geom, base=dv, alpha=-1.0)),
        ("lista3d_syn_adjoint", "base, alpha=+1", LB,
         lambda f: f(g, ws_adj[k], zh[k - 1], geom, base=dv, alpha=1.0)),
        ("lista3d_wgrad", "dA = -dv (*) r", LB,
         lambda f: f(rh[k - 1], dv, taps, geom.off_a, alpha=-1.0)),
        ("lista3d_wgrad", "dB = adjoint of -z (*) g", LB,
         lambda f: f(g, zh[k - 1], taps, geom.off_a, alpha=-1.0)),
        ("lista3d_wgrad", "dA masked", LB,
         lambda f: f(rh[k - 1], dv, taps, geom.off_a, alpha=-1.0, rows=rows)),
        ("lista3d_wgrad", "dB masked", LB,
         lambda f: f(g, zh[k - 1], taps, geom.off_a, alpha=-1.0, rows=rows)),
        ("lista3d_syn_residual", "A-adjoint g = m * Ak*(dv)", L,
         lambda f: f(dv, wa_adj[k], geom, mask=mask)),
    ]
    for name, case, mod, run in cases:
        got = run(getattr(mod, name))
        ref = run(getattr(mod, name + "_plain"))
        torch.cuda.synchronize()
        compare(name, what + case, got, ref, err)
        del got, ref
    return dict(k=k, geom=geom, taps=taps, y2=y2, wa=wa, ws=ws, tau=tau, zh=zh, rh=rh,
                wa_adj=wa_adj, ws_adj=ws_adj, mask=mask, dv=dv, g=g, rows=rows)


def reverse_times(A, B, ops, s, reps) -> dict:
    """ms per call (CUDA events, median of 5) at one training batch's
    operands (reverse_parity) of each reverse kernel and of the forward pair
    as training runs them: the kernel, its plain version, the one PyTorch
    call of the same function, and the bound. wgrad runs as each reverse
    step does, dA then dB, masked, and reports per call; "lista3d_wgrad
    dense" times it on every phase row."""
    k, geom, taps, y2, wa, ws, tau, zh, rh, wa_adj, ws_adj, mask, dv, g, rows = (
        ops[n] for n in ("k", "geom", "taps", "y2", "wa", "ws", "tau", "zh", "rh", "wa_adj",
                         "ws_adj", "mask", "dv", "g", "rows"))
    pads, C = geom.pads, A.shape[2]
    n_pos = y2[:, 0].numel()
    g_full = pp.depth_to_space(g, s, 3, C)
    r_full = pp.depth_to_space(rh[k - 1], s, 3, C)
    wg = torch.nn.grad.conv3d_weight

    def pair(f, lib=False, kw=None):
        if lib:
            return lambda: (wg(r_full, A[k].shape, dv, stride=s, padding=pads),
                            wg(g_full, B[k].shape, zh[k - 1], stride=s, padding=pads))
        kw = {"rows": rows} if kw is None else kw
        return lambda: (f(rh[k - 1], dv, taps, geom.off_a, alpha=-1.0, **kw),
                        f(g, zh[k - 1], taps, geom.off_a, alpha=-1.0, **kw))

    times = {}
    for name, run, plain, lib, banks, io in (
        ("lista3d_syn_adjoint",
         lambda: LB.lista3d_syn_adjoint(g, ws_adj[k], zh[k - 1], geom, base=dv, alpha=-1.0),
         lambda: LB.lista3d_syn_adjoint_plain(g, ws_adj[k], zh[k - 1], geom, base=dv,
                                              alpha=-1.0),
         lambda: F.conv3d(g_full, B[k], stride=s, padding=pads),
         (ws_adj[k],), (g, ws_adj[k], dv, zh[k - 1], dv, tau[0])),
        ("lista3d_wgrad",  # dA = -dv (*) r, then dB = -g (*) z
         pair(LB.lista3d_wgrad), pair(LB.lista3d_wgrad_plain), pair(None, lib=True),
         (wa[k], ws[k]), (rh[k - 1], dv, wa[k], g, zh[k - 1], ws[k])),
        ("lista3d_wgrad dense",
         pair(LB.lista3d_wgrad, kw={}), pair(LB.lista3d_wgrad_plain, kw={}),
         pair(None, lib=True), (torch.ones_like(wa[k]), torch.ones_like(ws[k])),
         (rh[k - 1], dv, wa[k], g, zh[k - 1], ws[k])),
        ("lista3d_ana_threshold train",
         lambda: L.lista3d_ana_threshold(rh[k - 1], zh[k - 1], wa[k], tau[k], geom),
         lambda: L.lista3d_ana_threshold_plain(rh[k - 1], zh[k - 1], wa[k], tau[k], geom),
         lambda: F.conv3d(r_full, A[k], stride=s, padding=pads),
         (wa[k],), (rh[k - 1], zh[k - 1], wa[k], tau[k], zh[k])),
        ("lista3d_syn_residual train",
         lambda: L.lista3d_syn_residual(zh[k - 1], ws[k], geom, y=y2),
         lambda: L.lista3d_syn_residual_plain(zh[k - 1], ws[k], geom, y=y2),
         lambda: F.conv_transpose3d(zh[k - 1], B[k], stride=s, padding=pads,
                                    output_padding=s - 1),
         (ws[k],), (zh[k - 1], ws[k], y2, y2)),  # reads y, writes r (y's size)
        ("lista3d_syn_residual A-adjoint",
         lambda: L.lista3d_syn_residual(dv, wa_adj[k], geom, mask=mask),
         lambda: L.lista3d_syn_residual_plain(dv, wa_adj[k], geom, mask=mask),
         lambda: F.conv_transpose3d(dv, A[k], stride=s, padding=pads, output_padding=s - 1),
         (wa_adj[k],), (dv, wa_adj[k], mask, y2)),
    ):
        calls = len(banks)
        tt = dict(zip(("ms", "plain_ms", "library_ms"),
                      (cuda_ms(f, reps) / calls for f in (run, plain, lib))))
        tt["bound_ms"], tt["bound_by"] = bound(banks, n_pos, io, calls,
                                               tf32x3=name.split()[0] in TC_KERNELS)
        times[name] = tt
    return times


def grads(m, noisy, sig, clean):
    """d(mse)/d(A, B, t) of model m on one noisy batch."""
    loss = mse_loss(m(noisy, sig)[0], clean)
    return torch.autograd.grad(loss, (m.A, m.B, m.t))


def step_launches_3d(K) -> dict:
    """Launches of one video training step of K iterations: forward K + K,
    reverse K syn_adjoint, K-1 syn_residual (the analysis adjoint) and 2K
    wgrad (dA and dB)."""
    return {"lista3d_ana_threshold": K, "lista3d_syn_residual": 2 * K - 1,
            "lista3d_syn_adjoint": K, "lista3d_wgrad": 2 * K}


def bucketed(clip) -> np.ndarray:
    """A (D, H, W) clip reflect-padded to the Denoiser's 64-pixel buckets."""
    pads = [(0, 0)] + [(0, -(-n // 64) * 64 - n) for n in clip.shape[1:]]
    return np.pad(clip, pads, mode="reflect")


def max_abs(a, b) -> float:
    return float(np.abs(a - b).max())


def observed_3d(rng, clean, dev):
    """(noisy, sigma (N, 1, 1, 1, 1)) on dev of the clean numpy clip batch
    (N, C, D, H, W): AWGN at a sigma per clip uniform in TRAIN_SIGMA."""
    sig = rng.uniform(*TRAIN_SIGMA, (clean.shape[0], 1, 1, 1, 1)).astype(np.float32)
    noisy = clean + sig / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (noisy, sig))


def bigframe(dev, card, err, model, t_par, tg, flagship_step_ms) -> tuple[dict, dict]:
    """The native-resolution video path: kernel parity and K=30 forwards at
    the big-frame shapes, native clips through Denoiser.denoise_video
    (whole, streamed, tiled), the analyze3d eval CLI, and big-frame
    training (reverse parity at 8x256^2 and at the native step's shape, a
    native step, the train CLI's video branch). Returns (launches of the
    native serve, eval CLI, native step and train CLI runs, the kernels'
    times at the native serve shape, at 8x256^2 and at the native step's
    shape)."""
    rng = np.random.default_rng(SEED + 50)  # the earlier phases keep their draws
    K, s = FLAGSHIP["K"], FLAGSHIP["s"]
    c = SIGMA / 255
    native = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    native.load_state_dict(model.state_dict())
    with torch.no_grad():
        native.t.copy_(t_par)  # thresholds > 0, so the soft threshold is exercised
    native_plain = copy.deepcopy(native)
    native_plain.backend = "xla"
    mri = CDLNetVideo(**MRI_3D, backend="pallas").to(dev)
    mri.init(torch.Generator().manual_seed(SEED + 3))
    clean = smooth_clip(rng, NATIVE[0], NATIVE[1:])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    launches = collections.Counter()

    # --- B1. each forward kernel against its plain version at the big-frame
    # shapes, and timed there; the K=30 forward against the plain loop at the
    # first and last ---
    times = {}
    with torch.inference_mode():
        for what, m, clip, full in (
            ("serve 16x480x854 (bucket 512x896)", native, bucketed(noisy), True),
            ("eval 16x240x432", native, noisy[:, :HALF_NATIVE[1], :HALF_NATIVE[2]], False),
            ("mri eval 30x320x192 (9,9,5)", mri, smooth_clip(rng, *MRI_VOLUME[:1],
                                                             MRI_VOLUME[1:]), True),
        ):
            yp, _, _ = pre_process_3d(torch.from_numpy(np.ascontiguousarray(clip))[None, None]
                                      .to(dev), s)
            ops = forward_parity(m.A, m.B, t_par, yp, s, c, tg, err, what + " ")
            if full:
                k_ms, p_ms = k_forward_parity(m.A, m.B, t_par, yp, s, c, what, time_it=True)
                n_pos = ops["y2"][:, 0].numel()
                print(f"time [{card}]: K={K} forward {what}: {k_ms:.3f} ms on the kernels, "
                      f"{p_ms:.3f} ms on the plain loop; {1e3 * k_ms / n_pos:.4f} us per "
                      f"code position on the kernels", flush=True)
            times[what] = forward_times(m.A[1], m.B[1], ops, s, reps=3)
            del ops, yp
    torch.cuda.empty_cache()

    # --- B2. a native clip through Denoiser.denoise_video (the serve path),
    # and the trained demo at native size, known and blind sigma ---
    server, server_plain = Denoiser(native), Denoiser(native_plain)
    L.launches.clear()
    out = server.denoise_video(noisy, sigma=SIGMA)
    torch.cuda.synchronize()
    serve_launches = dict(L.launches)
    launches.update(serve_launches)
    print(f"bigframe serve: one {NATIVE} clip, launches {serve_launches}", flush=True)
    require(serve_launches == {"lista3d_ana_threshold": K, "lista3d_syn_residual": K},
            f"a native clip launched {serve_launches}, expected {K} of each forward kernel")
    require(out.shape == NATIVE and np.isfinite(out).all(), "native serve output")
    serve_ms = host_ms(lambda: server.denoise_video(noisy, sigma=SIGMA), rounds=3)
    print(f"time [{card}]: Denoiser.denoise_video of a {NATIVE} clip at the flagship width "
          f"{serve_ms:.3f} ms host clock ({1e3 * NATIVE[0] / serve_ms:.2f} frames/s)",
          flush=True)
    demo, demo_plain = Denoiser.from_dir(DEMO), Denoiser.from_dir(DEMO, backend="xla")
    for label, sig in (("known", SIGMA), ("blind", None)):
        got = demo.denoise_video(noisy, sigma=sig)
        d = max_abs(got, demo_plain.denoise_video(noisy, sigma=sig))
        p_in, p_out = psnr(noisy, clean), psnr(got, clean)
        print(f"bigframe demo {label} sigma: PSNR noisy {p_in:.3f} dB -> denoised "
              f"{p_out:.3f} dB (gain {p_out - p_in:.3f} dB); kernels vs xla max|d| {d:.3e}",
              flush=True)
        require(np.isfinite(got).all() and p_out - p_in >= MIN_GAIN_DB,
                f"native demo {label} gain {p_out - p_in:.3f} dB < {MIN_GAIN_DB} dB")
        require(d <= 1e-4, f"native demo {label} kernels vs xla max|d| {d:.3e} > 1e-4")

    # --- B3. streaming: a 48-frame native clip in chunks (staged on the card)
    # against backend "xla", the pipelined host loop against the staged one,
    # and 256^2 tiles against "xla" ---
    long_clean = np.concatenate([clean, clean[::-1], clean])  # continuous in time
    long_noisy = long_clean + SIGMA / 255 * rng.standard_normal(
        long_clean.shape).astype(np.float32)
    kw = dict(sigma=SIGMA, chunk_depth=CHUNK, overlap=OVERLAP)
    L.launches.clear()
    t0 = time.perf_counter()
    got = server.denoise_video(long_noisy, **kw)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    chunks = len(streaming._chunk_starts(len(long_noisy), CHUNK, OVERLAP))
    require(dict(L.launches) == {"lista3d_ana_threshold": chunks * K,
                                 "lista3d_syn_residual": chunks * K},
            f"the streamed clip launched {dict(L.launches)}, expected {chunks} chunks")
    d = max_abs(got, server_plain.denoise_video(long_noisy, **kw))
    p_in, p_out = psnr(long_noisy, long_clean), psnr(got, long_clean)
    print(f"bigframe stream: {long_noisy.shape} in {chunks} chunks of {CHUNK} (overlap "
          f"{OVERLAP}) in {stream_s:.3f} s host clock; kernels vs xla max|d| {d:.3e}; PSNR "
          f"{p_in:.3f} -> {p_out:.3f} dB", flush=True)
    require(d <= 1e-4, f"streamed clip kernels vs xla max|d| {d:.3e} > 1e-4")
    padded = bucketed(long_noisy)[None, None]
    with torch.inference_mode():
        t0 = time.perf_counter()
        staged = streaming.denoise_long_video(native, torch.from_numpy(padded).to(dev),
                                              SIGMA, chunk_depth=CHUNK, overlap=OVERLAP)
        staged = staged.cpu().numpy()
        staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    piped = streaming.denoise_long_video_pipelined(native, padded, SIGMA, chunk_depth=CHUNK,
                                                   overlap=OVERLAP)
    piped_s = time.perf_counter() - t0
    print(f"time [{card}]: {padded.shape} clip staged {staged_s:.3f} s, pipelined host loop "
          f"{piped_s:.3f} s (host clock); equal: {np.array_equal(piped, staged)}", flush=True)
    require(np.array_equal(piped, staged), "the pipelined stream differs from the staged one")
    tkw = dict(sigma=SIGMA, tile_hw=TILE, overlap_hw=TILE_OVERLAP)
    t0 = time.perf_counter()
    tiled = server.denoise_video(noisy, **tkw)
    tiled_s = time.perf_counter() - t0
    d = max_abs(tiled, server_plain.denoise_video(noisy, **tkw))
    agree = 10 * np.log10(np.mean(out ** 2) / np.mean((tiled - out) ** 2))
    print(f"bigframe tiled: {NATIVE} in {TILE}^2 tiles (overlap {TILE_OVERLAP}) in "
          f"{tiled_s:.3f} s host clock; kernels vs xla max|d| {d:.3e}; {agree:.1f} dB "
          f"agreement with the whole-frame output", flush=True)
    require(d <= 1e-4, f"tiled clip kernels vs xla max|d| {d:.3e} > 1e-4")
    del server, server_plain, demo, demo_plain, staged, piped, got, tiled
    torch.cuda.empty_cache()

    # --- B4. the eval CLI (cli.analyze3d.main with no device: the card) with
    # the video demo on native 16-frame clips written as PNG frames ---
    with open(os.path.join(DEMO, "args.json")) as f:
        demo_args = json.load(f)
    Kd = demo_args["model"]["K"]
    with tempfile.TemporaryDirectory() as root:
        test_dir = os.path.join(root, "davis")
        vclean = [smooth_clip(rng, NATIVE[0], NATIVE[1:]) for _ in range(CLI_VIDEOS)]
        for i, v in enumerate(vclean):
            vdir = os.path.join(test_dir, f"video{i:03d}")
            os.makedirs(vdir)
            for j, frame in enumerate(v):
                img_save(os.path.join(vdir, f"{j:05d}.png"), frame[None])
        save_dir = os.path.join(root, "eval")
        args = dict(demo_args, paths={"save": save_dir,
                                      "ckpt": os.path.join(DEMO, "net.ckpt.npz")})
        vdir0 = os.path.join(test_dir, "video000")
        flags = ["args.json", "--test", test_dir, "--noise_level", "25", "--save",
                 "--passthrough", vdir0, "--dictionary", "--filters"]
        if CARD_HAS_MATPLOTLIB:
            flags.append("--thresholds")
        L.launches.clear()
        t0 = time.perf_counter()
        analyze3d.main(build_argparser().parse_args(flags), args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        eval_launches = dict(L.launches)
        launches.update(eval_launches)
        # two test clips and the passthrough forward: K + K launches each
        want = {"lista3d_ana_threshold": (CLI_VIDEOS + 1) * Kd,
                "lista3d_syn_residual": (CLI_VIDEOS + 1) * Kd}
        with open(os.path.join(save_dir, "test_davis_None.txt")) as f:
            txt = f.read()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        files = {os.path.relpath(os.path.join(d_, f_), save_dir)
                 for d_, _, fs in os.walk(save_dir) for f_ in fs}
        frames = CLI_VIDEOS * NATIVE[0]
        expect = ({f"test_noise/noise_{n:05d}.png" for n in range(1, frames + 1)}
                  | {f"test_output/output_{n:05d}.png" for n in range(1, frames + 1)}
                  | {f"passthrough_video000/{p}_{n:05d}.png" for p in ("noise", "output",
                                                                      "compare")
                     for n in range(1, NATIVE[0] + 1)}
                  | {f"passthrough_video000/csc{k:02d}.png" for k in range(Kd)}
                  | {f"filters/AB{k:02d}_True.png" for k in range(Kd)}
                  | {"passthrough_video000/psnr.txt", "filters/D_filters_True.png",
                     "D_learned.png", "freq_response.png"}
                  | ({"tau.png"} if CARD_HAS_MATPLOTLIB else set()))
        print(f"bigframe eval CLI: {CLI_VIDEOS} clips of {NATIVE} in {cli_s:.2f} s; launches "
              f"{eval_launches}; test_davis_None.txt {txt!r}; eval row "
              f"{ {k: v for k, v in rows[-1].items() if k != 'ts'} }; {len(files)} files "
              f"(--thresholds {'on' if CARD_HAS_MATPLOTLIB else 'off: no matplotlib'})",
              flush=True)
        require(eval_launches == want, f"the eval CLI launched {eval_launches}, expected {want}")
        require(re.fullmatch(r"25, \d+\.\d{3}\n", txt) is not None
                and float(txt.split(", ")[1]) > psnr(noisy, clean) + MIN_GAIN_DB,
                f"the eval CLI's txt {txt!r}")
        require(len(rows) == 1 and {k: rows[0][k] for k in
                                    ("event", "dataset", "blind", "sigma", "clips", "frames")}
                == dict(event="eval", dataset="davis", blind="None", sigma=25.0,
                        clips=CLI_VIDEOS, frames=frames)
                and abs(rows[0]["psnr"] - float(txt.split(", ")[1])) < 1e-3,
                f"the eval CLI's metrics rows {rows}")
        require(expect <= files, f"the eval CLI did not write {sorted(expect - files)[:5]}")
        # the same clips with --blind PCA: each test forward at its clip's
        # framewise PCA estimate, averaged
        L.launches.clear()
        t0 = time.perf_counter()
        analyze3d.main(build_argparser().parse_args(
            ["args.json", "--test", test_dir, "--noise_level", "25", "--blind", "PCA"]), args)
        torch.cuda.synchronize()
        pca_s = time.perf_counter() - t0
        pca_launches = dict(L.launches)
        launches.update(pca_launches)
        with open(os.path.join(save_dir, "test_davis_PCA.txt")) as f:
            pca_txt = f.read()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            pca_row = [json.loads(ln) for ln in f if ln.strip()][-1]
        print(f"bigframe eval CLI --blind PCA: {CLI_VIDEOS} clips of {NATIVE} in {pca_s:.2f} s; "
              f"launches {pca_launches}; test_davis_PCA.txt {pca_txt!r}", flush=True)
        want = {"lista3d_ana_threshold": CLI_VIDEOS * Kd, "lista3d_syn_residual": CLI_VIDEOS * Kd}
        require(pca_launches == want, f"the --blind PCA eval launched {pca_launches}")
        require(re.fullmatch(r"25, \d+\.\d{3}\n", pca_txt) is not None
                and float(pca_txt.split(", ")[1]) > psnr(noisy, clean) + MIN_GAIN_DB
                and pca_row["blind"] == "PCA" and pca_row["clips"] == CLI_VIDEOS,
                f"the --blind PCA eval's txt {pca_txt!r} or row {pca_row}")
        # the passthrough's per-iteration codes: kernels vs the plain loop
        dm = init_model(args)[0].eval()
        dm_plain = init_model(dict(args, model=dict(args["model"], backend="xla")))[0].eval()
        x = torch.from_numpy(load_video(vdir0)).to(dev)
        y = x + SIGMA / 255 * torch.randn(x.shape, generator=tg).to(dev)
        with torch.inference_mode():
            got, ref = dm.apply_with_codes(y, SIGMA), dm_plain.apply_with_codes(y, SIGMA)
        torch.cuda.synchronize()
        for name, a, b in zip(("x", "z", "codes"), got, ref):
            dd, rel = rel_err(a, b)
            print(f"parity passthrough {name} kernels vs plain loop: max|d| {dd:.3e}, "
                  f"rel {rel:.3e}", flush=True)
            require(rel <= FORWARD_TOL, f"passthrough {name} rel err {rel:.3e}")
        require(tuple(got[2].shape) == (Kd, 1, dm.M, NATIVE[0] // 2, NATIVE[1] // 2,
                                        NATIVE[2] // 2), f"codes {tuple(got[2].shape)}")
        del dm, dm_plain, x, y, got, ref

    # --- B5. big-frame training: reverse kernels and the K=30 gradient at
    # 1x8x256^2, the reverse kernels at the native size and one step there,
    # two epochs of the train CLI ---
    clean_b = smooth_clip(rng, BIG_TRAIN[0], BIG_TRAIN[1:])[None, None]
    clean_bt = torch.from_numpy(clean_b).to(dev)
    noisy_bt, sig_bt = observed_3d(rng, clean_b, dev)
    with torch.no_grad():
        tops = reverse_parity(native.A, native.B, t_par, noisy_bt, sig_bt, s, tg, err,
                              "1x8x256^2 ")
        times["train 1x8x256^2"] = reverse_times(native.A, native.B, tops, s, reps=10)
    del tops
    L.launches.clear()
    g1 = grads(native, noisy_bt, sig_bt, clean_bt)
    torch.cuda.synchronize()
    require(dict(L.launches) == step_launches_3d(K),
            f"one 1x8x256^2 gradient launched {dict(L.launches)}")
    g2 = grads(native, noisy_bt, sig_bt, clean_bt)
    gp = grads(native_plain, noisy_bt, sig_bt, clean_bt)
    torch.cuda.synchronize()
    for name, a, b, ref in zip("ABt", g1, g2, gp):
        dd, rel = rel_err(a, ref)
        print(f"parity K={K} gradient d{name} (1x{BIG_TRAIN}): max|d| {dd:.3e}, rel "
              f"{rel:.3e}; two runs bitwise equal: {torch.equal(a, b)}", flush=True)
        require(rel <= GRAD_TOL, f"1x8x256^2 gradient d{name} rel err {rel:.3e} > {GRAD_TOL}")
        require(torch.equal(a, b), f"two 1x8x256^2 backward runs differ in d{name}")
    del g1, g2, gp, native_plain
    # the reverse kernels at the native step's own shape (1x16x480x854, code
    # grid 8x240x427: ragged 64-column tiles, 138 M position-channels per
    # history), on the histories of a native forward
    nat_noisy, nat_sig = observed_3d(rng, clean[None, None], dev)
    nat = "1x" + "x".join(map(str, NATIVE))
    with torch.no_grad():
        tops = reverse_parity(native.A, native.B, t_par, nat_noisy, nat_sig, s, tg, err,
                              nat + " ")
        times["train " + nat] = reverse_times(native.A, native.B, tops, s, reps=2)
    del tops, nat_noisy, nat_sig
    torch.cuda.empty_cache()
    opt = make_optimizer(2e-4, clip_grad=0.05)
    state = opt.init(dict(native.named_parameters()))
    step_ms = host_ms(lambda: train_update(native, opt, state, noisy_bt, sig_bt, clean_bt),
                      rounds=3)
    # the native step through make_train_step(workload="3d"), the step fit()
    # runs: a clean 1x16x480x854 clip (no bucket pad in training), its noise
    # drawn on the card
    train_step, _ = make_train_step(native, opt, workload="3d", noise_std=TRAIN_SIGMA)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nat_clean = torch.from_numpy(clean[None, None]).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L.launches.clear()
    loss = train_step(state, nat_clean, gen)
    torch.cuda.synchronize()
    step_launches = dict(L.launches)
    launches.update(step_launches)
    require(step_launches == step_launches_3d(K),
            f"the native train step launched {step_launches}")
    nat_ms = host_ms(lambda: train_step(state, nat_clean, gen), rounds=2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(bool(torch.isfinite(loss)) and all(torch.isfinite(p).all()
                                               for p in native.parameters()),
            "the native train step gave a non-finite loss or parameter")
    print(f"time [{card}]: flagship train step (fwd + bwd + Adam + project) at 1x{BIG_TRAIN} "
          f"{step_ms:.3f} ms, at 1x{NATIVE} {nat_ms:.3f} ms through make_train_step (noise "
          f"drawn on the card; peak {peak:.2f} GB), on the kernels; launches per step "
          f"{step_launches}", flush=True)
    del native, nat_clean, noisy_bt, clean_bt, state
    torch.cuda.empty_cache()

    # the train CLI's video branch (cli.train.main with no device: the card)
    # with the video demo's config from its power-method init, its batches
    # assembled in the calling thread, then by a pool of loader threads
    with tempfile.TemporaryDirectory() as root:
        data = gen_synthetic_video_dirs(os.path.join(root, "data"), n_videos=CLI_TRAIN_VIDEOS,
                                        depth=NATIVE[0], size=CLI_VIDEO_SIZE, seed=SEED)
        pipeline, runs = {}, []
        for workers in CLI_WORKERS:
            save_dir = os.path.join(root, f"run{workers}")
            args = copy.deepcopy(demo_args)
            args["paths"] = {"save": save_dir}
            args["train"]["fit"].update(epochs=CLI_EPOCHS, val_freq=1, save_freq=1,
                                        backtrack_thresh=None, verbose=False)
            args["train"]["loaders"].update(
                {f"{k}_path_list": [os.path.join(data, split)]
                 for k, split in (("trn", "train"), ("val", "val"), ("tst", "test"))},
                num_workers=workers)
            loaders, workload = cli_train.make_loaders(args)
            t0 = time.perf_counter()
            n_batches = sum(1 for _ in loaders["train"])
            loader_ms = 1e3 * (time.perf_counter() - t0) / n_batches
            L.launches.clear()
            t0 = time.perf_counter()
            cli_state, history = cli_train.main(args)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            cli_launches = dict(L.launches)
            launches.update(cli_launches)
            runs.append(cli_launches)
            n_steps = CLI_EPOCHS * len(loaders["train"])
            evals = CLI_EPOCHS * len(loaders["val"]) + len(loaders["test"])
            want = {name: n_steps * n for name, n in step_launches_3d(Kd).items()}
            want["lista3d_ana_threshold"] += evals * Kd
            want["lista3d_syn_residual"] += evals * Kd
            with open(os.path.join(save_dir, "metrics.jsonl")) as f:
                rows = [json.loads(ln) for ln in f if ln.strip()]
            last = [r for r in rows if r.get("event") == "phase" and r["phase"] == "train"][-1]
            pipeline[workers] = (loader_ms, 1e3 * last["sec"] / last["steps"])
            print(f"bigframe train CLI (num_workers={workers}): {workload} workload, {n_steps} "
                  f"steps + {evals} eval clips in {cli_s:.2f} s; launches {cli_launches}; PSNR "
                  f"{[(e, ph, round(p, 3)) for e, ph, p in history]}; video loader "
                  f"{loader_ms:.3f} ms per training batch (host clock)", flush=True)
            require(workload == "3d" and cli_launches == want,
                    f"the train CLI launched {cli_launches}, expected {want}")
            require([(e, ph) for e, ph, _ in history]
                    == [(1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]
                    and all(np.isfinite(p) for _, _, p in history),
                    f"the train CLI's history {history}")
            with open(os.path.join(save_dir, "args.json")) as f:
                saved = json.load(f)
            back, _, back_state, epoch0, _ = init_model(saved)
            require(saved["paths"]["ckpt"] == os.path.join(save_dir, "net.ckpt.npz")
                    and back.A.device.type == "cuda" and epoch0 == CLI_EPOCHS
                    and back_state["count"] == cli_state["count"] == n_steps
                    and all(torch.isfinite(p).all() for p in back.parameters()),
                    "the video train CLI's checkpoint did not reload through its args.json")
            del back, back_state, cli_state
        require(all(r == runs[0] for r in runs), f"the train CLI's launches differ: {runs}")
        print(f"pipeline [{card}]: video train CLI ({CLI_TRAIN_VIDEOS} clips of "
              f"{NATIVE[0]} PNG frames at {CLI_VIDEO_SIZE}^2, batch "
              f"{demo_args['train']['loaders']['batch_size'][0]}): "
              + "; ".join(f"num_workers={w}: loader {lm:.3f} ms host per training batch, CLI "
                          f"{sm:.3f} ms per step (last epoch's train phase)"
                          for w, (lm, sm) in pipeline.items())
              + f"; the flagship train step {flagship_step_ms:.3f} ms", flush=True)

    for shape, tt_all in times.items():
        for name, tt in tt_all.items():
            print(f"time [{card}]: bigframe {shape} {name}: {tt['ms']:.4f} ms/call, plain "
                  f"{tt['plain_ms']:.4f}, library {tt['library_ms']:.4f}, bound "
                  f"{tt['bound_ms']:.4f} ({tt['bound_by']})", flush=True)
    print(f"bigframe launches: per native clip {serve_launches}, per native step "
          f"{step_launches}", flush=True)
    # each kernel's times at the big-frame shapes, by kernel
    by_kernel = {}
    for shape, tt_all in times.items():
        for name, tt in tt_all.items():
            by_kernel.setdefault(name.split()[0], {})[f"{shape} {name}".strip()] = tt
    return dict(launches), by_kernel


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| in float64 (numpy arrays or tensors)."""
    got, ref = (torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
                .double() for a in (got, ref))
    return float((got - ref).norm() / ref.norm())


def csr_f2_gate(what, got, ref, clean) -> float:
    """Hold an output of the two-sided prox against its reference: relative
    L2 error <= CSR_L2_TOL and PSNR gap (against the clean input) <=
    CSR_PSNR_GAP_DB. Returns max|got - ref|."""
    got, ref = (a.cpu().numpy() if torch.is_tensor(a) else a for a in (got, ref))
    d, l2 = max_abs(got, ref), rel_l2(got, ref)
    gap = abs(psnr(got, clean) - psnr(ref, clean))
    print(f"parity {what}: rel L2 {l2:.3e}, PSNR gap {gap:.2e} dB, max|d| {d:.3e}",
          flush=True)
    require(l2 <= CSR_L2_TOL, f"{what}: rel L2 {l2:.3e} > {CSR_L2_TOL}")
    require(gap <= CSR_PSNR_GAP_DB, f"{what}: PSNR gap {gap:.3e} dB > {CSR_PSNR_GAP_DB}")
    return d


def csr_volume_launches(two_sided, K, D) -> dict:
    """Launches of one D-frame volume through a CSR model's recurrence, K +
    K per frame application: CDLNet_CSR runs f0 with no code, then D + 1
    frames with the previous code (its warm-up f1, f0 and frames 1..D-1);
    CDLNet_CSRf2 runs f0 with no code, frames 1..D-1 with the previous
    code, f0 with its own code as z_after, and one two-sided batch of the
    D - 1 frames."""
    if two_sided:
        return {"lista2d_ana_threshold": K, "lista2d_ana_csr": D * K,
                "lista2d_ana_csrf2": K, "lista2d_syn_residual": (D + 2) * K}
    return {"lista2d_ana_threshold": K, "lista2d_ana_csr": (D + 1) * K,
            "lista2d_syn_residual": (D + 2) * K}


class VolumeLoader:
    """An in-memory stand-in for data/fastmri.py's test loader: (1, 1, D, H,
    W) volume batches, and the .h5 paths analyzemri.test names the dataset
    by."""

    def __init__(self, volumes, root):
        self.volumes = volumes
        self.dataset = type("VolumeSet", (), {})()
        self.dataset.h5_files = [os.path.join(root, f"vol{i:03d}.h5")
                                 for i in range(len(volumes))]

    def __iter__(self):
        return iter(v[None, None] for v in self.volumes)


def csr_models(dev) -> dict:
    """CDLNet_CSR and CDLNet_CSRf2 at CSR_WIDTH, each on the kernels and on
    "xla", sharing one power-method bank (CDLNet_CSR's first-frame banks
    set to it: the reference's default A2/B2 init is expansive), positive
    thresholds and gamma banks in [0, 0.3] per column (the trained
    csr-demo's gammas lie in [-0.12, 0.32])."""
    f2 = CDLNetCSRf2(**CSR_WIDTH, backend="pallas").to(dev).init(
        torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        f2.t.copy_(torch.rand(f2.t.shape, generator=g)
                   * torch.tensor([0.02, 0.2]).reshape(1, 2, 1, 1, 1))
        f2.g1.copy_(0.3 * torch.rand(f2.g1.shape, generator=g))
        f2.g2.copy_(0.3 * torch.rand(f2.g2.shape, generator=g))
        one = CDLNetCSR(**CSR_WIDTH, backend="pallas").to(dev)
        for name, src in (("A", f2.A), ("B", f2.B), ("t", f2.t), ("A2", f2.A),
                          ("B2", f2.B), ("t2", f2.t), ("g", f2.g1)):
            getattr(one, name).copy_(src)
    out = {}
    for family, m in (("CDLNet_CSR", one), ("CDLNet_CSRf2", f2)):
        plain = copy.deepcopy(m)
        plain.backend = "xla"
        out[family] = (m.eval(), plain.eval())
    return out


def csr(dev, card, err) -> tuple[dict, dict]:
    """The frame-recurrent CSR serve path: the CSR analysis kernels against
    their plain versions and timed, the K=30 forwards against the plain
    loop, a native volume through Denoiser.denoise_video for both models,
    the trained csr-demo, and cli.analyzemri.test. Returns (launches of the
    served volumes, the demo and the eval CLI; the CSR kernels' times at
    the served 640x384 frame, with the 2x128^2 ones under "2x128^2")."""
    rng = np.random.default_rng(SEED + 60)  # the earlier phases keep their draws
    models = csr_models(dev)
    f2 = models["CDLNet_CSRf2"][0]
    K, s = f2.K, f2.s
    launches = collections.Counter()

    # --- C1. each CSR analysis kernel (and the ST one) against its plain
    # version on a frame's phase operands, the neighbour codes the kernels'
    # K=30 forwards of the frames before and after it; timed at 2x128^2 and
    # at the served 640x384 frame ---
    times, codes = {}, {}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for label, shape, sigmas in (("2x128^2", IMAGE, [20.0, 30.0]),
                                     ("640x368", MRI_FRAME, [SIGMA]),
                                     ("640x384 (bucket)", (640, 384), [SIGMA])):
            N = len(sigmas)
            clean = np.stack([smooth_clip(rng, 3, shape) for _ in sigmas])  # (N, 3, H, W)
            sig = np.asarray(sigmas, np.float32).reshape(-1, 1, 1, 1)
            noisy = clean + sig / 255 * rng.standard_normal(clean.shape).astype(np.float32)
            y = torch.from_numpy(noisy).to(dev)
            sig_t = torch.from_numpy(sig.reshape(-1)).to(dev)
            zp = f2(y[:, 0:1], sigma=sig_t)[1]
            za = f2(y[:, 2:3], sigma=sig_t)[1]
            yp, _, _ = pre_process(y[:, 1:2], s)
            c = sig_t / 255
            y2, _, wa, ws, tau, geom = L2.phase_operands(yp, f2.A, f2.B, f2.t, c, s)
            gam1, gam2 = (L2.threshold_bank(b, c, N, yp) for b in (f2.g1, f2.g2))
            z0 = L2.lista2d_ana_csrf2_plain(-y2, None, wa[0], tau[0], gam1[0], gam2[0],
                                            zp, za, geom)
            r1 = L2.lista2d_syn_residual_plain(z0, ws[1], geom, y=y2)
            cases = (
                ("lista2d_ana_threshold", "st k=1", (r1, z0, wa[1], tau[1])),
                ("lista2d_ana_csr", "z_prev k=0", (-y2, None, wa[0], tau[0], gam1[0], zp)),
                ("lista2d_ana_csr", "z_prev k=1", (r1, z0, wa[1], tau[1], gam1[1], zp)),
                ("lista2d_ana_csr", "z_after alone k=1", (r1, z0, wa[1], tau[1], gam2[1], za)),
                ("lista2d_ana_csrf2", "k=0",
                 (-y2, None, wa[0], tau[0], gam1[0], gam2[0], zp, za)),
                ("lista2d_ana_csrf2", "k=1", (r1, z0, wa[1], tau[1], gam1[1], gam2[1], zp, za)),
            )
            for name, what, args in cases:
                got = getattr(L2, name)(*args, geom)
                ref = getattr(L2, name + "_plain")(*args, geom)
                torch.cuda.synchronize()
                if name != "lista2d_ana_csrf2":
                    compare(name, f"csr {label} {what}", got, ref, err)
                    continue
                v = L2.ana_argument_plain(*args[:3], geom)
                keep = L2.csrf2_jump_gap(v, zp, za, args[3], args[5]) \
                    > CSR_JUMP_EPS * v.abs().max()
                excl = int((~keep).sum())
                d_all = float((got - ref).abs().max())
                d = float(((got - ref).abs() * keep).max())
                rel = d / float(ref.abs().max())
                print(f"parity {name} [csr {label} {what}]: max|d| {d:.3e}, rel {rel:.3e} "
                      f"over the codes with |v - Ca| > {CSR_JUMP_EPS} max|v|; {excl} codes "
                      f"({excl / keep.numel():.3e}) excluded; max|d| over all {d_all:.3e}",
                      flush=True)
                require(rel <= KERNEL_TOL, f"{name} [{label} {what}] rel err {rel:.3e}")
                err[name] = max(err.get(name, 0.0), d_all)
            codes[label] = (zp, za)
            if label == "640x368":
                continue
            r_full = pp.depth_to_space(r1, s, 2, 1)
            n_pos = y2[:, 0].numel()
            tt = {}
            for name, args, io in (
                ("lista2d_ana_threshold", (r1, z0, wa[1], tau[1]), (r1, z0, wa[1], tau[1], z0)),
                ("lista2d_ana_csr", (r1, z0, wa[1], tau[1], gam1[1], zp),
                 (r1, z0, wa[1], tau[1], gam1[1], zp, z0)),
                ("lista2d_ana_csrf2", (r1, z0, wa[1], tau[1], gam1[1], gam2[1], zp, za),
                 (r1, z0, wa[1], tau[1], gam1[1], gam2[1], zp, za, z0)),
            ):
                run, plain = (lambda f=getattr(L2, n), a=args: f(*a, geom)
                              for n in (name, name + "_plain"))
                tt[name] = dict(zip(("ms", "plain_ms", "library_ms"), (cuda_ms(f, 20) for f in (
                    run, plain,
                    lambda: F.conv2d(r_full, f2.A[1], stride=s, padding=f2.pad)))))
                tt[name]["bound_ms"], tt[name]["bound_by"] = bound(
                    (wa[1],), n_pos, io, tf32x3=name in TC_KERNELS)
                print(f"time [{card}]: csr {label} {name}: {tt[name]['ms']:.4f} ms/call, "
                      f"plain {tt[name]['plain_ms']:.4f}, library {tt[name]['library_ms']:.4f}, "
                      f"bound {tt[name]['bound_ms']:.4f} ({tt[name]['bound_by']})", flush=True)
            for name in ("lista2d_ana_csr", "lista2d_ana_csrf2"):
                if label == "2x128^2":
                    times.setdefault(name, {})[label] = tt[name]
                else:
                    times.setdefault(name, {}).update(tt[name])
    print(f"csr: kernel parity and times in {time.perf_counter() - t0:.2f} s", flush=True)

    # --- C2. the K=30 forwards on the kernels against the plain loop at a
    # raw native frame (640x368: ragged code-grid tiles), with the previous
    # frame's code (CDLNet_CSR) and both neighbours' (CDLNet_CSRf2) ---
    zp, za = codes["640x368"]
    clean = smooth_clip(rng, 1, MRI_FRAME)[None]  # (1, 1, H, W)
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    y = torch.from_numpy(noisy).to(dev)
    with torch.inference_mode():
        for family, kw in (("CDLNet_CSR", dict(z_prev=zp)),
                           ("CDLNet_CSRf2", dict(z_prev=zp, z_after=za))):
            model, plain = models[family]
            got, ref = model(y, sigma=SIGMA, **kw), plain(y, sigma=SIGMA, **kw)
            torch.cuda.synchronize()
            what = f"{family} K={K} forward 640x368 ({', '.join(kw)})"
            if family == "CDLNet_CSR":
                for name, a, b in zip("xz", got, ref):
                    d, rel = rel_err(a, b)
                    print(f"parity {what} {name}: max|d| {d:.3e}, rel {rel:.3e}", flush=True)
                    require(rel <= FORWARD_TOL, f"{what} {name} rel err {rel:.3e}")
            else:
                csr_f2_gate(f"{what} x", got[0], ref[0], clean)
                d = float((got[1] - ref[1]).abs().max())
                l2 = rel_l2(got[1], ref[1])
                print(f"parity {what} z: rel L2 {l2:.3e}, max|d| {d:.3e}", flush=True)
                require(l2 <= CSR_L2_TOL, f"{what} z rel L2 {l2:.3e}")
            k_ms = cuda_ms(lambda: model(y, sigma=SIGMA, **kw), 1, rounds=3, warmup=1)
            p_ms = cuda_ms(lambda: plain(y, sigma=SIGMA, **kw), 1, rounds=3, warmup=1)
            print(f"time [{card}]: {what}: {k_ms:.3f} ms on the kernels, {p_ms:.3f} ms on "
                  "the plain loop", flush=True)
    del codes, got, ref
    torch.cuda.empty_cache()

    # --- C3. a native 16-frame volume through Denoiser.denoise_video (the
    # serve path), known and blind sigma, against backend "xla" ---
    vol_clean = smooth_clip(rng, CSR_DEPTH, MRI_FRAME)
    vol = vol_clean + SIGMA / 255 * rng.standard_normal(vol_clean.shape).astype(np.float32)
    for family, (model, plain) in models.items():
        two_sided = family == "CDLNet_CSRf2"
        server, server_plain = Denoiser(model), Denoiser(plain)
        L.launches.clear()
        outs = {"known": server.denoise_video(vol, sigma=SIGMA),
                "blind": server.denoise_video(vol)}
        torch.cuda.synchronize()
        got = dict(L.launches)
        launches.update(got)
        want = {n: 2 * v for n, v in csr_volume_launches(two_sided, K, CSR_DEPTH).items()}
        print(f"csr serve: {family}, a {(CSR_DEPTH, *MRI_FRAME)} volume known and blind, "
              f"launches {got}", flush=True)
        require(got == want, f"{family}: two volumes launched {got}, expected {want}")
        for label, out in outs.items():
            ref = server_plain.denoise_video(vol, sigma=SIGMA if label == "known" else None)
            require(out.shape == vol.shape and np.isfinite(out).all(), f"{family} output")
            what = f"{family} served volume {label} sigma, kernels vs xla"
            if two_sided:
                csr_f2_gate(what, out, ref, vol_clean)
            else:
                d = max_abs(out, ref)
                print(f"parity {what}: max|d| {d:.3e}", flush=True)
                require(d <= FORWARD_TOL, f"{what} max|d| {d:.3e} > {FORWARD_TOL}")
            print(f"csr serve: {family} {label} sigma: PSNR noisy {psnr(vol, vol_clean):.3f} "
                  f"dB -> {psnr(out, vol_clean):.3f} dB", flush=True)
        for label, sig in (("known", SIGMA), ("blind", None)):
            ms = host_ms(lambda: server.denoise_video(vol, sigma=sig), rounds=3)
            apps = CSR_DEPTH + 2
            print(f"time [{card}]: {family} Denoiser.denoise_video of a {(CSR_DEPTH, *MRI_FRAME)} "
                  f"volume, {label} sigma: {ms:.3f} ms host clock ({1e3 * CSR_DEPTH / ms:.2f} "
                  f"frames/s; {apps} frame applications of {2 * K} launches)", flush=True)
        if two_sided:  # blind PCA: one sigma a volume, its frames' mean estimate
            pca = Denoiser(model, blind="PCA")
            L.launches.clear()
            out = pca.denoise_video(vol)
            torch.cuda.synchronize()
            got = dict(L.launches)
            launches.update(got)
            frames = torch.from_numpy(bucketed(vol)[:, None]).to(dev)
            sig_hat = float(255.0 * nle.noise_level(frames, "PCA").mean())
            ms = host_ms(lambda: pca.denoise_video(vol), rounds=3)
            print(f"time [{card}]: {family} Denoiser(blind=\"PCA\").denoise_video of a "
                  f"{(CSR_DEPTH, *MRI_FRAME)} volume: sigma {SIGMA} -> sigma-hat {sig_hat:.3f}; "
                  f"{ms:.3f} ms host clock; PSNR {psnr(vol, vol_clean):.3f} dB -> "
                  f"{psnr(out, vol_clean):.3f} dB; launches {got}", flush=True)
            want = csr_volume_launches(True, K, CSR_DEPTH)
            require(got == want, f"{family}: a blind PCA volume launched {got}, expected {want}")
            require(out.shape == vol.shape and np.isfinite(out).all()
                    and abs(sig_hat / SIGMA - 1) <= PCA_SIGMA_TOL,
                    f"{family} blind PCA volume: sigma-hat {sig_hat:.3f}")
            del pca, frames
        del server, server_plain, outs
    del models, f2
    torch.cuda.empty_cache()

    # --- C4. the trained csr-demo (CDLNet_CSRf2) on smooth 128^2 volumes,
    # known and blind sigma: it must denoise, on the kernels and "xla" alike ---
    demo, demo_plain = Denoiser.from_dir(CSR_DEMO), Denoiser.from_dir(CSR_DEMO, backend="xla")
    require(demo.device.type == "cuda", "Denoiser.from_dir did not default to the card")
    Kd = demo.model.K
    d_clean = smooth_clip(rng, CSR_DEPTH, IMAGE)
    d_noisy = d_clean + SIGMA / 255 * rng.standard_normal(d_clean.shape).astype(np.float32)
    L.launches.clear()
    outs = {"known": demo.denoise_video(d_noisy, sigma=SIGMA), "blind": demo.denoise_video(d_noisy)}
    torch.cuda.synchronize()
    got = dict(L.launches)
    launches.update(got)
    want = {n: 2 * v for n, v in csr_volume_launches(True, Kd, CSR_DEPTH).items()}
    require(got == want, f"the csr demo launched {got}, expected {want}")
    for label, out in outs.items():
        ref = demo_plain.denoise_video(d_noisy, sigma=SIGMA if label == "known" else None)
        csr_f2_gate(f"csr-demo {label} sigma, kernels vs xla", out, ref, d_clean)
        p_in, p_out = psnr(d_noisy, d_clean), psnr(out, d_clean)
        print(f"csr demo {label} sigma: PSNR noisy {p_in:.3f} dB -> denoised {p_out:.3f} dB "
              f"(gain {p_out - p_in:.3f} dB)", flush=True)
        require(np.isfinite(out).all() and p_out - p_in >= MIN_GAIN_DB,
                f"csr demo {label} gain {p_out - p_in:.3f} dB < {MIN_GAIN_DB} dB")
    del demo, demo_plain

    # --- C5. the eval CLI's test (cli.analyzemri.test) with the csr-demo on
    # native volumes held in memory; analyzemri.main too where h5py imports ---
    with open(os.path.join(CSR_DEMO, "args.json")) as f:
        demo_args = json.load(f)
    depth = demo_args["train"]["loaders"]["depth"]
    with tempfile.TemporaryDirectory() as root:
        save_dir = os.path.join(root, "eval")
        os.makedirs(save_dir)
        args = dict(demo_args, paths={"save": save_dir,
                                      "ckpt": os.path.join(CSR_DEMO, "net.ckpt.npz")})
        # the model analyzemri.main builds: --backend auto takes the kernels
        model = init_model(cli_train.apply_backend("auto", args))[0].eval()
        loader = VolumeLoader([smooth_clip(rng, depth, MRI_FRAME) for _ in
                               range(CSR_CLI_VOLUMES)], os.path.join(root, "fastmri"))
        L.launches.clear()
        t0 = time.perf_counter()
        analyzemri.test(model, demo_args["type"], loader, [25], None, save_dir, True, False)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        got = dict(L.launches)
        launches.update(got)
        want = {n: CSR_CLI_VOLUMES * v
                for n, v in csr_volume_launches(True, model.K, depth).items()}
        with open(os.path.join(save_dir, "test_fastmri_None.txt")) as f:
            txt = f.read()
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        files = {os.path.relpath(os.path.join(d_, f_), save_dir)
                 for d_, _, fs in os.walk(save_dir) for f_ in fs}
        frames = CSR_CLI_VOLUMES * depth
        expect = {f"{sub}/{p}_{n:05d}.png" for sub, p in (("test_noise", "noise"),
                                                           ("test_output", "output"),
                                                           ("test_gt", "gt"))
                  for n in range(1, frames + 1)}
        print(f"csr eval CLI: analyzemri.test on {CSR_CLI_VOLUMES} volumes of "
              f"{(depth, *MRI_FRAME)} in {cli_s:.2f} s; launches {got}; "
              f"test_fastmri_None.txt {txt!r}; eval row "
              f"{ {k: v for k, v in rows[-1].items() if k != 'ts'} }; {len(files)} files",
              flush=True)
        require(got == want, f"the eval CLI launched {got}, expected {want}")
        m = re.fullmatch(r"25, PSNR: (\d+\.\d{3}), SSIM: (0\.\d{4})\n", txt)
        require(m is not None and float(m.group(1)) > 20 * np.log10(255 / 25) + MIN_GAIN_DB,
                f"the eval CLI's txt {txt!r}")
        require(len(rows) == 1 and {k: rows[0][k] for k in
                                    ("event", "dataset", "blind", "sigma", "volumes", "frames")}
                == dict(event="eval", dataset="fastmri", blind="None", sigma=25.0,
                        volumes=CSR_CLI_VOLUMES, frames=frames)
                and 0.0 < rows[0]["ssim"] <= 1.0, f"the eval CLI's metrics rows {rows}")
        require(expect <= files, f"the eval CLI did not write {sorted(expect - files)[:5]}")
        try:
            import h5py  # noqa: F401
        except ImportError:
            print("csr eval CLI: h5py is not installed beside the card, so "
                  "analyzemri.main's .h5 loader does not run here; "
                  "tests/test_torch_cli_analyzemri.py runs it on the CPU", flush=True)
        else:
            mri = gen_synthetic_mri_dirs(os.path.join(root, "mri"), n_volumes=1,
                                         slices=depth, splits=("test",))
            analyzemri.main(build_argparser().parse_args(
                ["args.json", "--test", os.path.join(mri, "test"), "--noise_level", "25",
                 "--save_dir", os.path.join(root, "main")]), args)
            with open(os.path.join(root, "main", "test_test_None.txt")) as f:
                line = f.read()
            print(f"csr eval CLI: analyzemri.main on .h5 volumes: {line!r}", flush=True)
            require(re.fullmatch(r"25, PSNR: \d+\.\d{3}, SSIM: 0\.\d{4}\n", line)
                    is not None, f"analyzemri.main's txt {line!r}")
    return dict(launches), times


class GradRecorder:
    """An optimizer stand-in for make_csr_train_step: it keeps the
    gradients a step hands it, so two runs can be compared."""

    def update(self, params, grads, state):
        state.update({n: g.clone() for n, g in grads.items()})


def csr_prox_branches(u, zp, za, tau, g1, g2):
    """The branch of the CSR prox that an argument u falls in, elementwise:
    the signs that the adjoint kernels read (sign(0) = 0), stacked. One-sided
    (za None, prox_csr toward zp with g1): the inner soft threshold's sign
    and the output's. Two-sided (prox_csr_f2): the sign of u - Ca, then of
    the inner, middle and outer soft thresholds."""
    soft = lambda x, th: torch.sign(x) * torch.relu(x.abs() - th)
    sg = torch.sign
    if za is None:
        shift = zp + tau * sg(zp)
        inner = soft(u - shift, tau * g1)
        return torch.stack([sg(inner), sg(soft(inner + shift, tau))])
    Ca = csr_f2_jump(zp, za, tau, g2)
    Cb = za + tau * sg(za) + tau * g1 * sg(za - zp)
    inner = soft(u - Ca, g1 * tau)
    corr = tau * g1 * sg(u - Ca)
    midder = soft(inner - Cb + corr, g2 * tau)
    return torch.stack([sg(u - Ca), sg(inner), sg(midder), sg(soft(midder + Cb - corr, tau))])


def csr_branch_flips(model, y, codes) -> tuple:
    """Where the kernels' forward and the plain loop ("xla") put a CSR
    prox argument in different branches: the recurrent apply of `model` on
    frame y (N, C, H, W) at SIGMA with the neighbour `codes` (z_prev, and
    z_after for CDLNet_CSRf2), its K prox arguments u_k read from the
    kernels' u history and from the plain loop's prox calls. Returns
    (flips (K, N, M, Hc, Wc) bool, u_kernels, u_plain, the thresholds
    (tau, g1, g2) of each k as (N, M, 1, 1) tensors)."""
    zp, za = codes["z_prev"].detach(), codes.get("z_after")
    za = None if za is None else za.detach()
    g1 = model.g1 if isinstance(model, CDLNetCSRf2) else model.g
    g2 = getattr(model, "g2", None)
    with torch.no_grad():
        yp, _, mask, c = _prepare(model, y, SIGMA, None)
        y2, m2, wa, ws, tau, geom = L2.phase_operands(yp, model.A, model.B, model.t, c,
                                                       model.s, mask)
        banks = (g1,) if za is None else (g1, g2)
        gams = tuple(L2.threshold_bank(b, c, y.shape[0], yp) for b in banks)
        u_kern = L2.lista2d_loop(y2, m2, wa, ws, tau, geom, return_hists=True, gams=gams,
                                 codes=(zp,) if za is None else (zp, za))[2][2]
        u_plain, ths = [], []

        def record(u, k, c_):
            th = [_threshold(b[k], c_) for b in (model.t, g1, g2) if b is not None]
            u_plain.append(u)
            ths.append(th)
            if za is None:
                return prox_csr(u, zp, *th)
            return prox_csr_f2(u, zp, za, *th)

        lista_2d(yp, model.A, model.B, model.t, c, mask=mask, stride=model.s, prox=record)
        u_plain = torch.stack(u_plain)
        flips = torch.stack([
            (csr_prox_branches(u_kern[k], zp, za, *(ths[k] + [None])[:3])
             != csr_prox_branches(u_plain[k], zp, za, *(ths[k] + [None])[:3])).any(0)
            for k in range(len(ths))])
    return flips, u_kern, u_plain, ths


def csr_on_branches(model, y, z_prev, branches):
    """CDLNet_CSR's recurrent apply on the plain loop (backend "xla") with
    each iteration's prox_csr evaluated on the given branches (the signs of
    csr_prox_branches, one pair per iteration) in place of its argument's
    own: the same affine piece of the prox, so this is the plain loop on
    the kernels' side of every boundary. Returns (xhat, z) as
    model(y, z_prev, sigma=SIGMA)."""
    yp, prm, mask, c = _prepare(model, y, SIGMA, None)

    def prox(u, k, c_):
        tau, gam = _threshold(model.t[k], c_), _threshold(model.g[k], c_)
        a, b = branches[k]
        shift = z_prev + tau * torch.sign(z_prev)
        inner = a.abs() * (u - shift - a * tau * gam)
        return b.abs() * (inner + shift - b * tau)

    z = lista_2d(yp, model.A, model.B, model.t, c, mask=mask, stride=model.s, prox=prox)
    x = conv_transpose2d(z, model.B[0], stride=model.s, padding=model.pad,
                         output_padding=model.s - 1)
    return post_process(x, prm), z


def csr_kink_gap(u, zp, tau, g1) -> torch.Tensor:
    """|u - the nearest boundary of prox_csr's branches| elementwise (the
    inner soft threshold's at u - shift = +-tau g1; the outer's, where the
    inner one passes u on, at inner + shift = +-tau)."""
    shift = zp + tau * torch.sign(zp)
    d = u - shift
    inner = torch.sign(d) * torch.relu(d.abs() - tau * g1)
    outer = torch.where(inner != 0, ((inner + shift).abs() - tau).abs(),
                        torch.full_like(u, float("inf")))
    return torch.minimum((d.abs() - tau * g1).abs(), outer)


def csr_step_launches(two_sided, K, remat=False) -> dict:
    """Launches of one make_csr_train_step step (4 frame applications, each
    a K-iteration forward of K analyses and K syntheses, and in reverse K
    adjoints, K - 1 analysis adjoints and 2K wgrads): CDLNet_CSR runs one
    first-frame (ST) apply and three with the previous code; CDLNet_CSRf2
    one ST apply, two one-sided (z_prev; z_after alone) and one two-sided.
    remat runs each forward again in the backward."""
    fwd = 2 if remat else 1
    if two_sided:
        ana = {"lista2d_ana_threshold": K, "lista2d_ana_csr": 2 * K, "lista2d_ana_csrf2": K}
        adj = {"lista2d_syn_adjoint": K, "lista2d_syn_adjoint_csr": 2 * K,
               "lista2d_syn_adjoint_csrf2": K}
    else:
        ana = {"lista2d_ana_threshold": K, "lista2d_ana_csr": 3 * K}
        adj = {"lista2d_syn_adjoint": K, "lista2d_syn_adjoint_csr": 3 * K}
    out = {n: fwd * v for n, v in ana.items()} | adj
    out["lista2d_syn_residual"] = 4 * (fwd * K + K - 1)
    out["lista2d_wgrad"] = 4 * 2 * K
    return out


def csr_eval_launches(two_sided, K) -> dict:
    """Launches of one make_csr_train_step eval (the 4 applies' forwards)."""
    out = {n: v for n, v in csr_step_launches(two_sided, K).items() if "ana" in n}
    out["lista2d_syn_residual"] = 4 * K
    return out


def csr_train(dev, card, err) -> tuple[dict, dict]:
    """The frame-recurrent CSR training path at the argscsr width: the CSR
    adjoint kernels (and the P=9 synthesis) against their plain versions
    and timed, the K=30 gradients through the kernels against "xla" for
    both models, make_csr_train_step at native 640x368 (remat on and off,
    kernels and "xla"), and fit_csr for FIT_STEPS steps. Returns (launches
    of the native steps and the fit_csr run; the adjoints' times at the
    640x384 bucket, with the 1x128^2 ones under "1x128^2", and the P=9
    synthesis's in a dict of their own)."""
    rng = np.random.default_rng(SEED + 80)  # the earlier phases keep their draws
    models = csr_models(dev)
    f2 = models["CDLNet_CSRf2"][0]
    K, s = f2.K, f2.s
    launches = collections.Counter()

    # --- R1. each CSR adjoint kernel against its plain version on a K=30
    # forward's u and z histories, the neighbour codes the forwards of the
    # frames before and after; timed at 1x128^2 and the 640x384 bucket ---
    times, syn_p9 = {}, {}
    t0 = time.perf_counter()
    with torch.no_grad():
        for label, shape in (("1x128^2", IMAGE), ("640x368", MRI_FRAME),
                             ("640x384 (bucket)", (640, 384))):
            clean = smooth_clip(rng, 3, shape)[None]  # (1, 3, H, W)
            y = torch.from_numpy(clean + SIGMA / 255 * rng.standard_normal(clean.shape)
                                 .astype(np.float32)).to(dev)
            zp = f2(y[:, 0:1], sigma=SIGMA)[1]
            za = f2(y[:, 2:3], sigma=SIGMA)[1]
            yp, _, _ = pre_process(y[:, 1:2], s)
            c = SIGMA / 255
            y2, _, wa, ws, tau, geom = L2.phase_operands(yp, f2.A, f2.B, f2.t, c, s)
            ws_adj = LB.adjoint_bank(ws, 2)
            gams = tuple(L2.threshold_bank(b, c, 1, yp) for b in (f2.g1, f2.g2))
            gen = torch.Generator().manual_seed(SEED)
            g = torch.randn(y2.shape, generator=gen).to(dev)
            base = 1e-2 * torch.randn(zp.shape, generator=gen).to(dev)
            k = K // 2
            cases = []
            for mode, codes, banks in (("csr", (zp,), gams[:1]), ("z_after alone", (za,), gams[1:]),
                                       ("csrf2", (zp, za), gams)):
                _, _, (zh, _, uh) = L2.lista2d_loop(y2, None, wa, ws, tau, geom,
                                                    return_hists=True, gams=banks, codes=codes)
                name = "lista2d_syn_adjoint_csrf2" if len(codes) == 2 else "lista2d_syn_adjoint_csr"
                ops = (g, ws_adj[k], zh[k - 1].clone(), uh[k - 1].clone(), tau[k - 1],
                       *(b[k - 1] for b in banks), *codes)
                cases.append((name, mode, ops, len(codes)))
                del zh, uh
            for name, mode, ops, n_codes in cases:
                bufs = [torch.zeros_like(zp) for _ in range(n_codes)]
                pbufs = [torch.zeros_like(zp) for _ in range(n_codes)]
                got = getattr(LB2, name)(*ops, *bufs, geom, base=base, alpha=-1.0)
                ref = getattr(LB2, name + "_plain")(*ops, *pbufs, geom, base=base, alpha=-1.0)
                torch.cuda.synchronize()
                compare(name, f"csr train {label} {mode} k={k - 1} (dv, dtau, dgam"
                        f"{', dgam2' if n_codes == 2 else ''}, dz_prev"
                        f"{', dz_after' if n_codes == 2 else ''})",
                        (*got, *bufs), (*ref, *pbufs), err)
            # the soft-threshold adjoint and the weight gradient (masked, as
            # the reverse loop runs it) at the same shape, on the same codes
            rows, zk = LB.phase_rows(geom, wa.shape[1], 2), cases[0][2][2]
            for name, what, run in (
                ("lista2d_syn_adjoint", "ST adjoint",
                 lambda f: f(g, ws_adj[k], zk, geom, base=base, alpha=-1.0)),
                ("lista2d_wgrad", "dB masked",
                 lambda f: f(g, zk, tuple(wa.shape[2:4]), geom.off_a, alpha=-1.0, rows=rows)),
            ):
                got, ref = run(getattr(LB2, name)), run(getattr(LB2, name + "_plain"))
                torch.cuda.synchronize()
                compare(name, f"csr train {label} {what}", got, ref, err)
            if label == "640x368":
                continue
            g_full = pp.depth_to_space(g, s, 2, 1)
            n_pos = y2[:, 0].numel()
            tt = {}
            for name, mode, ops, n_codes in cases:
                if mode == "z_after alone":
                    continue
                bufs = [torch.zeros_like(zp) for _ in range(n_codes)]
                run, plain = (lambda f=getattr(LB2, n), o=ops, b=bufs: f(*o, *b, geom, base=base,
                                                                          alpha=-1.0)
                              for n in (name, name + "_plain"))
                tt[name] = dict(zip(("ms", "plain_ms", "library_ms"), (cuda_ms(f, 20) for f in (
                    run, plain,
                    lambda: F.conv2d(g_full, f2.B[k], stride=s, padding=f2.pad)))))
                # the same calls replayed from a CUDA graph: the device's time
                # alone, without the host's cost of a launch
                tt[name]["graph_ms"] = statistics.median(graph_ms(run, 5, 20))
                # read: ops (g, the bank, z, u, tau, the gammas, the codes),
                # base and the code cotangents; written: dv (code-sized),
                # the code cotangents and the (N, M) sums (tau- and
                # gamma-sized)
                io = (*ops, base, *bufs, *bufs, zp, ops[4], *ops[5:5 + n_codes])
                tt[name]["bound_ms"], tt[name]["bound_by"] = bound((ws_adj[k],), n_pos, io,
                                                                   tf32x3=True)
            # the soft-threshold reverse pair on the same operands (the CSR
            # epilogue's cost; the P=9 taps' weight gradient, masked as the
            # reverse loop runs it), with their library calls and bounds
            zk, taps = cases[0][2][2], tuple(wa.shape[2:4])
            for name, run, lib, banks, io in (
                ("lista2d_syn_adjoint (ST, the same operands)",
                 lambda: LB2.lista2d_syn_adjoint(g, ws_adj[k], zk, geom, base=base, alpha=-1.0),
                 lambda: F.conv2d(g_full, f2.B[k], stride=s, padding=f2.pad),
                 (ws_adj[k],), (g, ws_adj[k], base, zk, zk, tau[0])),
                ("lista2d_wgrad (dB, masked)",
                 lambda: LB2.lista2d_wgrad(g, zk, taps, geom.off_a, alpha=-1.0, rows=rows),
                 lambda: torch.nn.grad.conv2d_weight(g_full, f2.B[k].shape, zk, stride=s,
                                                     padding=f2.pad),
                 (ws[k],), (g, zk, ws[k])),
            ):
                ms, lib_ms = cuda_ms(run, 20), cuda_ms(lib, 20)
                g_ms = statistics.median(graph_ms(run, 5, 20))
                b_ms, b_by = bound(banks, n_pos, io, tf32x3=True)
                print(f"time [{card}]: csr train {label} {name}: {ms:.4f} ms/call (graph "
                      f"{g_ms:.4f}), library {lib_ms:.4f}, bound {b_ms:.4f} ({b_by})", flush=True)
            # the P=9 synthesis a CSR forward launches 30 times (and its
            # reverse 29 as the analysis adjoint)
            r = L2.lista2d_syn_residual(zp, ws[1], geom, y=y2)
            syn = lambda: L2.lista2d_syn_residual(zp, ws[1], geom, y=y2)
            syn_plain = lambda: L2.lista2d_syn_residual_plain(zp, ws[1], geom, y=y2)
            p9 = syn_p9[label] = dict(zip(("ms", "plain_ms", "library_ms"), (
                cuda_ms(f, 20) for f in (syn, syn_plain, lambda: F.conv_transpose2d(
                    zp, f2.B[1], stride=s, padding=f2.pad, output_padding=s - 1)))))
            p9["bound_ms"], p9["bound_by"] = bound((ws[1],), n_pos, (zp, ws[1], y2, r),
                                                   tf32x3=True)
            compare("lista2d_syn_residual", f"csr train {label} P=9", r, syn_plain(), err)
            for name, t_ in (*tt.items(), ("lista2d_syn_residual P=9", p9)):
                graph = f" (graph {t_['graph_ms']:.4f})" if "graph_ms" in t_ else ""
                print(f"time [{card}]: csr train {label} {name}: {t_['ms']:.4f} ms/call{graph}, "
                      f"plain {t_['plain_ms']:.4f}, library {t_['library_ms']:.4f}, "
                      f"bound {t_['bound_ms']:.4f} ({t_['bound_by']})", flush=True)
            for name, t_ in tt.items():
                if label == "1x128^2":
                    times.setdefault(name, {})[label] = t_
                else:
                    times.setdefault(name, {}).update(t_)
            del cases
    print(f"csr train: adjoint kernel parity and times in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # --- R2. the K=30 gradient through the kernels against torch autograd
    # on "xla", every parameter and the carried codes, bitwise repeatable:
    # a first-frame apply and a recurrent one (both codes for CSRf2) on one
    # 1x128^2 frame pair ---
    clean = smooth_clip(rng, 2, IMAGE)[None]
    y = torch.from_numpy(clean + SIGMA / 255 * rng.standard_normal(clean.shape)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        z_nb = {"z_prev": f2(y[:, 0:1], sigma=SIGMA)[1], "z_after": f2(y[:, 1:2], sigma=SIGMA)[1]}
    for family, (model, plain) in models.items():
        kws = ("z_prev",) if family == "CDLNet_CSR" else ("z_prev", "z_after")

        def csr_grads(m, recurrent=None):
            """The gradients of a first-frame apply and a recurrent one
            (`recurrent(**codes)` in place of m's own when given)."""
            codes = {n: z_nb[n].clone().requires_grad_() for n in kws}
            x0, z0 = m(y[:, 1:2], sigma=SIGMA)
            x1, z1 = (recurrent or (lambda **cd: m(y[:, 0:1], sigma=SIGMA, **cd)))(**codes)
            loss = mse_loss(x0, torch.from_numpy(clean[:, 1:2]).to(dev)) \
                + mse_loss(x1, torch.from_numpy(clean[:, 0:1]).to(dev)) + 1e-2 * (z1 ** 2).mean()
            names = [n for n, _ in m.named_parameters()]
            return dict(zip(names + list(kws), torch.autograd.grad(
                loss, [p for _, p in m.named_parameters()] + list(codes.values()))))

        L.launches.clear()
        g1 = csr_grads(model)
        torch.cuda.synchronize()
        got = dict(L.launches)
        flips, u_kern, u_plain, ths = csr_branch_flips(model, y[:, 0:1],
                                                       {n: z_nb[n] for n in kws})
        flipped = flips.any(0)
        want = {"lista2d_ana_threshold": K, "lista2d_syn_residual": 2 * (2 * K - 1),
                "lista2d_syn_adjoint": K, "lista2d_wgrad": 4 * K,
                "lista2d_ana_csrf2" if len(kws) == 2 else "lista2d_ana_csr": K,
                "lista2d_syn_adjoint_csrf2" if len(kws) == 2 else "lista2d_syn_adjoint_csr": K}
        require(got == want, f"{family} gradient launched {got}, expected {want}")
        g2 = csr_grads(model)
        gp = csr_grads(plain)
        if family == "CDLNet_CSR":  # the plain loop on the kernels' branches
            branches = [csr_prox_branches(u_kern[k], z_nb["z_prev"], None, *ths[k][:2], None)
                        for k in range(K)]
            gb = csr_grads(plain, lambda z_prev: csr_on_branches(plain, y[:, 0:1], z_prev,
                                                                 branches))
        torch.cuda.synchronize()
        for name, a in g1.items():
            ref, d = gp[name], float((a - gp[name]).abs().max())
            same = torch.equal(a, g2[name])
            if name in kws:
                # a code's cotangent is elementwise: where an iteration's
                # prox argument u_k lies within the two programs' fp32
                # difference of a branch boundary, the kernels and the
                # plain loop take different branches and that code's
                # cotangent moves by the whole local gradient (and its
                # neighbours' by what that spreads). So the codes with such
                # a flip (`flipped`) are counted and the worst error traced
                # to its flip; CDLNet_CSR's codes are held elementwise at
                # GRAD_TOL max-rel against the plain loop on the kernels'
                # branches (csr_on_branches), and every code by its
                # relative L2 error against the plain loop's own
                l2 = rel_l2(a, ref)
                off, scale = (a - ref).abs(), float(ref.abs().max())
                far = off > GRAD_TOL * scale
                rest = float(off.masked_fill(flipped, 0).max()) / scale
                print(f"parity {family} K={K} gradient d{name} (1x{IMAGE[0]}^2): rel L2 "
                      f"{l2:.3e}, max|d| {d:.3e} (rel {d / scale:.3e}); {int(flipped.sum())} of "
                      f"{a.numel()} codes take another prox branch at some iteration on the "
                      f"kernels than on the plain loop; {int(far.sum())} codes off by more than "
                      f"{GRAD_TOL} max|ref|, {int((far & flipped).sum())} of them flipped; max "
                      f"rel over the codes that no iteration flips {rest:.3e}; two runs bitwise "
                      f"equal: {same}", flush=True)
                if family == "CDLNet_CSR":
                    worst = tuple(int(i) for i in np.unravel_index(int(off.argmax()), off.shape))
                    _, m_, i_, j_ = worst
                    for k in torch.nonzero(flips[(slice(None), *worst)]).flatten().tolist()[:3]:
                        tau_k, g_k = (float(th[0, m_, 0, 0]) for th in ths[k][:2])
                        uk, up = float(u_kern[(k, *worst)]), float(u_plain[(k, *worst)])
                        gap = float(csr_kink_gap(u_kern[k][worst], z_nb["z_prev"][worst],
                                                 tau_k, g_k))
                        print(f"parity {family} d{name}: the worst code {worst} flips at "
                              f"k={k}: u_k {uk:.9e} on the kernels, {up:.9e} on the plain "
                              f"loop (|d| {abs(uk - up):.3e}); the kernels' u_k lies "
                              f"{gap:.3e} from a branch boundary", flush=True)
                    rel_b = float((a - gb[name]).abs().max() / gb[name].abs().max())
                    print(f"parity {family} K={K} gradient d{name} (1x{IMAGE[0]}^2) against the "
                          f"plain loop on the kernels' prox branches: max rel {rel_b:.3e}",
                          flush=True)
                    require(rel_b <= GRAD_TOL, f"{family} d{name} rel err {rel_b:.3e} > "
                            f"{GRAD_TOL} on the kernels' branches")
                require(l2 <= GRAD_TOL, f"{family} d{name} rel L2 {l2:.3e} > {GRAD_TOL}")
            elif family == "CDLNet_CSR":
                rel = d / float(ref.abs().max())
                print(f"parity {family} K={K} gradient d{name} (1x{IMAGE[0]}^2): max|d| "
                      f"{d:.3e}, rel {rel:.3e}; two runs bitwise equal: {same}", flush=True)
                require(rel <= GRAD_TOL, f"{family} d{name} rel err {rel:.3e} > {GRAD_TOL}")
            else:
                l2 = rel_l2(a, ref)
                print(f"parity {family} K={K} gradient d{name} (1x{IMAGE[0]}^2): rel L2 "
                      f"{l2:.3e}, max|d| {d:.3e}; two runs bitwise equal: {same}", flush=True)
                require(l2 <= GRAD_TOL, f"{family} d{name} rel L2 {l2:.3e} > {GRAD_TOL}")
            require(same, f"{family}: two backward runs differ in d{name}")
        del g1, g2, gp, flips, u_kern, u_plain, ths

    # --- R3. make_csr_train_step at native 640x368 (the batches of
    # tools/bench_csr_bigframe.py: 1x1x3 frames for CSRf2, 1x1x2 for CSR):
    # remat bitwise equal to no remat; step ms and peak GB on the kernels
    # (remat "auto", on at this size, and off) and on "xla" (remat on) ---
    steps = {}
    vol = smooth_clip(rng, 3, MRI_FRAME)
    for family, (model, plain) in models.items():
        two_sided = family == "CDLNet_CSRf2"
        batch = torch.from_numpy(vol[None, None, :3 if two_sided else 2]).to(dev)
        recs = {}
        for remat in (False, True):
            step, _ = make_csr_train_step(model, GradRecorder(), noise_std=TRAIN_SIGMA,
                                          remat=remat)
            recs[remat] = {}
            L.launches.clear()
            loss = step(recs[remat], batch, torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            got = dict(L.launches)
            launches.update(got)
            want = csr_step_launches(two_sided, K, remat)
            print(f"csr train: {family} native step remat={remat}: loss {float(loss):.6f}, "
                  f"launches {got}", flush=True)
            require(got == want, f"{family} native step launched {got}, expected {want}")
        for name, gr in recs[False].items():
            require(torch.isfinite(gr).all() and torch.equal(gr, recs[True][name]),
                    f"{family}: remat and no remat differ in d{name}")
        print(f"csr train: {family} native step: remat and no remat bitwise equal in "
              f"{len(recs[False])} gradients", flush=True)
        del recs
        for label, m, remat in (("kernels", model, "auto"), ("kernels remat=False", model, False),
                                ("xla", plain, "auto")):
            opt = make_optimizer(1e-4, clip_grad=0.05)
            st = opt.init(dict(m.named_parameters()))
            step, _ = make_csr_train_step(m, opt, noise_std=TRAIN_SIGMA, remat=remat)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = host_ms(lambda: step(st, batch, gen), rounds=3)
            steps[(family, label)] = (ms, torch.cuda.max_memory_allocated() / 1e9)
            print(f"time [{card}]: {family} native train step (1x1x{batch.shape[2]}x"
                  f"{MRI_FRAME[0]}x{MRI_FRAME[1]}, fwd + bwd + Adam) on {label}: {ms:.3f} ms, "
                  f"peak {steps[(family, label)][1]:.2f} GB", flush=True)
            del opt, st
        del batch
    del models
    torch.cuda.empty_cache()

    # --- R4. fit_csr: FIT_STEPS steps of CDLNet_CSRf2 on 2 x 3 x 128^2
    # crops of in-memory volumes (h5py is not installed beside the card),
    # one step an epoch, with its launches and a checkpoint that reloads ---
    fit_model = csr_models(dev)["CDLNet_CSRf2"][0]
    vols = np.stack([smooth_clip(rng, 3, IMAGE)[None] for _ in range(2)])  # (2, 1, 3, H, W)
    loaders = {"train": [vols], "val": [vols], "test": [vols]}
    opt = make_optimizer(FIT_CSR_LR, clip_grad=0.05)
    state = opt.init(dict(fit_model.named_parameters()))
    with tempfile.TemporaryDirectory() as save_dir:
        L.launches.clear()
        t0 = time.perf_counter()
        state, history = fit_csr(fit_model, opt, state, loaders, save_dir=save_dir,
                                 epochs=FIT_STEPS, noise_std=TRAIN_SIGMA, val_freq=10,
                                 save_freq=10, verbose=False, seed=SEED)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(L.launches)
        launches.update(fit_launches)
        evals = sum(ph != "train" for _, ph, _ in history)
        want = collections.Counter({n: FIT_STEPS * v for n, v in
                                    csr_step_launches(True, K).items()})
        want.update({n: evals * v for n, v in csr_eval_launches(True, K).items()})
        losses = [10 ** (-p / 10) for _, ph, p in history if ph == "train"]
        print(f"csr fit: {FIT_STEPS} steps + {evals} evals in {fit_s:.2f} s; launches "
              f"{fit_launches}; train losses {[f'{v:.6f}' for v in losses]}", flush=True)
        require(fit_launches == dict(want), f"fit_csr launched {fit_launches}, expected {want}")
        require(len(losses) == FIT_STEPS and all(np.isfinite(losses)),
                f"non-finite or missing fit_csr losses {losses}")
        require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                f"fit_csr losses did not fall: first 5 {losses[:5]}, last 5 {losses[-5:]}")
        back = CDLNetCSRf2(**CSR_WIDTH).to(dev)
        back_state = opt.init(dict(back.named_parameters()))
        _, back_state, epoch, _ = load_ckpt(os.path.join(save_dir, f"net_epoch_{FIT_STEPS}"
                                                         ".ckpt.npz"), back, back_state)
        require(epoch == FIT_STEPS and back_state["count"] == FIT_STEPS
                and all(torch.equal(a, b) for a, b in
                        zip(back.parameters(), fit_model.parameters())),
                "fit_csr's checkpoint did not reload to the trained state")
    return dict(launches), times, syn_p9


def prefetch_phase(dev, card) -> None:
    """P1. data/prefetch.py::device_prefetch over PREFETCH_BATCHES seeded
    batches of the flagship train shape, a kernel running on the consumer's
    stream between yields: each batch the consumer reads (a clone after that
    kernel) is its host batch bit for bit, and a torch.profiler trace shows
    every host-to-device copy on a stream other than the consumer's."""
    rng = np.random.default_rng(SEED + 70)
    batches = [np.stack([smooth_clip(rng, *CLIP[:2])[None] for _ in range(TRAIN_N)])
               for _ in range(PREFETCH_BATCHES)]
    w = torch.randn(4096, 4096, device=dev)
    consumer = torch.cuda.current_stream(dev)
    seen = []
    with tempfile.TemporaryDirectory() as root:
        trace = os.path.join(root, "prefetch.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in device_prefetch(batches, device=dev):
                require(torch.cuda.current_stream(dev) == consumer, "the consumer's stream moved")
                for _ in range(3):
                    w = torch.tanh(w @ w * 1e-3)
                seen.append(batch.clone())
            torch.cuda.synchronize()
            loop_ms = 1e3 * (time.perf_counter() - t0)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    equal = all(torch.equal(a.cpu(), torch.from_numpy(b)) for a, b in zip(seen, batches))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copy_streams = {e["args"].get("stream") for e in copies}
    kernel_streams = {e["args"].get("stream") for e in kernels}
    copy_us = statistics.median(e["dur"] for e in copies) if copies else float("nan")
    print(f"prefetch: {len(seen)} batches of {(TRAIN_N, 1, *CLIP)} through device_prefetch "
          f"in {loop_ms:.3f} ms host clock with 3 matmuls of 4096^2 between yields; bitwise "
          f"equal to the host batches: {equal}; trace: {len(copies)} HtoD copies on streams "
          f"{sorted(copy_streams)} (median {copy_us:.1f} us), {len(kernels)} kernels on "
          f"streams {sorted(kernel_streams)}", flush=True)
    require(equal and len(seen) == PREFETCH_BATCHES,
            "a prefetched batch differs from its host batch")
    require(len(copies) >= PREFETCH_BATCHES and kernels,
            f"the trace holds {len(copies)} HtoD copies and {len(kernels)} kernels")
    require(not copy_streams & kernel_streams,
            f"HtoD copies on the consumer's stream: {sorted(copy_streams & kernel_streams)}")


def blind_pca(dev, card, model, t_par) -> dict:
    """P3. Blind PCA (nle/pca.py) through the serve path: the trained
    flagship 2D demo through denoise_image at 128^2 and 481x321 and
    denoise_image_batch (8 x 128^2, sigma 10 to 50), each sigma-hat within
    PCA_SIGMA_TOL of the true sigma, each PSNR gain within PCA_GAIN_GAP_DB
    of the known-sigma call's on the same image and >= MIN_GAIN_DB where
    sigma lies in the demo's training range (at sigma 10 the demo gains
    less than 3 dB on some smooth images at the known sigma too); the
    card's sigma-hats against the CPU's on the same images; and a native
    16x480x854 clip at the flagship width through denoise_video(blind
    "PCA"): sigma-hat, ms, and the estimator's share of the latency.
    Returns the launches of the served images and clip."""
    rng = np.random.default_rng(SEED + 80)
    launches = collections.Counter()
    server = Denoiser.from_dir(DEMO_2D, blind="PCA")
    K = server.model.K
    cases = [("128^2", *noisy_images(rng, IMAGE, [SIGMA])),
             ("481x321", *noisy_images(rng, BIG_IMAGE, [SIGMA])),
             ("batch 8 x 128^2", *noisy_images(rng, IMAGE, PCA_BATCH_SIGMAS))]
    L.launches.clear()
    outs = [server.denoise_image(noisy[0, 0]) if len(noisy) == 1
            else server.denoise_image_batch(noisy) for _, _, noisy in cases]
    torch.cuda.synchronize()
    got = dict(L.launches)
    launches.update(got)
    want = {"lista2d_ana_threshold": 3 * K, "lista2d_syn_residual": 3 * K}
    require(got == want, f"three blind PCA forwards launched {got}, expected {want}")
    for (label, clean, noisy), out in zip(cases, outs):
        sigmas = [SIGMA] if len(noisy) == 1 else PCA_BATCH_SIGMAS
        y = torch.from_numpy(noisy)
        est_card = 255.0 * nle.noise_level(y.to(dev), "PCA").reshape(-1).cpu().numpy()
        est_cpu = 255.0 * nle.noise_level(y, "PCA").reshape(-1).numpy()
        est_f64 = 255.0 * nle.noise_level(y.double().to(dev), "PCA").reshape(-1).cpu().numpy()
        out = out.reshape(noisy.shape)
        known = server.denoise_image_batch(noisy, sigmas=sigmas)
        gains = [psnr(o, c) - psnr(n, c) for o, c, n in zip(out, clean, noisy)]
        known_gains = [psnr(o, c) - psnr(n, c) for o, c, n in zip(known, clean, noisy)]
        rel_sig = np.abs(est_card / np.asarray(sigmas) - 1)
        rel_cpu = float(np.max(np.abs(est_card / est_cpu - 1)))
        rel_f64 = [float(np.max(np.abs(e / est_f64 - 1))) for e in (est_card, est_cpu)]
        gap = max(k - g for g, k in zip(gains, known_gains))
        trained = [g for g, sg in zip(gains, sigmas)
                   if DEMO_2D_SIGMAS[0] <= sg <= DEMO_2D_SIGMAS[1]]
        print(f"blind PCA {label}: sigma {[round(v, 3) for v in sigmas]} -> sigma-hat "
              f"{[round(float(v), 3) for v in est_card]} (max rel {rel_sig.max():.4f}; card vs "
              f"CPU rel {rel_cpu:.2e}; card and CPU vs float64 on the card {rel_f64[0]:.2e}, "
              f"{rel_f64[1]:.2e}); PSNR gains {[round(g, 3) for g in gains]} dB, at the "
              f"known sigma {[round(g, 3) for g in known_gains]} dB", flush=True)
        require(np.isfinite(out).all() and out.shape == noisy.shape, f"blind PCA {label} output")
        require(rel_sig.max() <= PCA_SIGMA_TOL,
                f"blind PCA {label}: sigma-hat off by {rel_sig.max():.3f} > {PCA_SIGMA_TOL}")
        require(gap <= PCA_GAIN_GAP_DB, f"blind PCA {label}: {gap:.3f} dB below the known sigma")
        require(min(trained) >= MIN_GAIN_DB, f"blind PCA {label}: gain {min(trained):.3f} dB")
        require(rel_cpu <= PCA_CPU_TOL, f"blind PCA {label}: card vs CPU rel {rel_cpu:.2e}")
    for label, (_, _, noisy) in zip(("128^2", "481x321"), cases):
        ms = host_ms(lambda: server.denoise_image(noisy[0, 0]))
        print(f"time [{card}]: flagship 2D demo denoise_image blind PCA at {label}: "
              f"{ms:.3f} ms host clock", flush=True)
    del server

    # a native clip at the flagship width, the whole-clip route
    native = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    native.load_state_dict(model.state_dict())
    with torch.no_grad():
        native.t.copy_(t_par)
    clean = smooth_clip(rng, NATIVE[0], NATIVE[1:])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    server = Denoiser(native, blind="PCA")
    L.launches.clear()
    out = server.denoise_video(noisy)
    torch.cuda.synchronize()
    got = dict(L.launches)
    launches.update(got)
    require(got == {"lista3d_ana_threshold": FLAGSHIP["K"], "lista3d_syn_residual": FLAGSHIP["K"]},
            f"a blind PCA native clip launched {got}")
    require(out.shape == NATIVE and np.isfinite(out).all(), "blind PCA native clip output")
    frames = torch.from_numpy(bucketed(noisy)[:, None]).to(dev)  # (D, 1, 512, 896)
    sig_hat = float(255.0 * nle.noise_level(frames, "PCA").mean())
    est_ms = host_ms(lambda: nle.noise_level(frames, "PCA"), rounds=3)
    blind_ms = host_ms(lambda: server.denoise_video(noisy), rounds=3)
    known_ms = host_ms(lambda: server.denoise_video(noisy, sigma=sig_hat), rounds=3)
    print(f"time [{card}]: blind PCA native {NATIVE} clip at the flagship width: sigma "
          f"{SIGMA} -> sigma-hat {sig_hat:.3f}; denoise_video {blind_ms:.3f} ms blind, "
          f"{known_ms:.3f} ms at that sigma; the estimator alone {est_ms:.3f} ms on the "
          f"{tuple(frames.shape)} bucketed frames ({100 * est_ms / blind_ms:.1f}% of the "
          f"blind latency; blind - known {blind_ms - known_ms:.3f} ms)", flush=True)
    require(abs(sig_hat / SIGMA - 1) <= PCA_SIGMA_TOL, f"native sigma-hat {sig_hat:.3f}")
    del server, native, frames
    torch.cuda.empty_cache()
    return dict(launches)


def residual_phase(dev, card) -> None:
    """P4. CDLNetVideo with residual blocks, which runs on the plain
    F.conv3d loop on every backend: the reference golden on the card, the
    flagship width with residual=True serving a 16x128^2 clip (forward ms,
    no kernel launch), and one train step at N=2 x 16x128^2 (finite loss,
    step ms, peak GB)."""
    data = np.load(os.path.join(GOLDEN, "cdlnet3d_res.npz"))
    sd = {k[4:]: data[k] for k in data.files if k.startswith("sd::")}
    params = {"A": np.stack([sd[f"A.{k}.weight"] for k in range(2)]),
              "B": np.stack([sd[f"B.{k}.weight"] for k in range(2)]), "t": sd["t"],
              "residual": {c: np.stack([sd[f"residual_blocks.{k}.{c}.weight"]
                                        for k in range(2)]) for c in ("conv1", "conv2")}}
    gold = load_jax_params(CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=1, C=1, adaptive=True,
                                       residual=True, backend="cuda"), params).to(dev)
    L.launches.clear()
    with torch.no_grad():
        xhat, z = gold(torch.from_numpy(data["x"]).to(dev), float(data["sigma"]), return_z=True)
    torch.cuda.synchronize()
    pairs = [(xhat.cpu().numpy(), data["xhat"]), (z.cpu().numpy(), data["z"])]
    dx, dz = (float(np.abs(a - b).max()) for a, b in pairs)
    ok = all(np.allclose(a, b, rtol=1e-4, atol=5e-5) for a, b in pairs)
    print(f"residual golden (cdlnet3d_res) on the card: max|d| xhat {dx:.3e}, z {dz:.3e}; "
          f"launches {dict(L.launches)}", flush=True)
    require(ok and not L.launches, "the residual golden on the card")

    model = CDLNetVideo(**FLAGSHIP, residual=True, backend="pallas").to(dev)
    model.init(torch.Generator().manual_seed(SEED + 5))
    rng = np.random.default_rng(SEED + 90)
    clean = smooth_clip(rng, *CLIP[:2])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    server = Denoiser(model)
    L.launches.clear()
    out = server.denoise_video(noisy, sigma=SIGMA)
    yc = torch.from_numpy(noisy)[None, None].to(dev)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(yc, SIGMA), reps=1, rounds=3, warmup=1)
    serve_ms = host_ms(lambda: server.denoise_video(noisy, sigma=SIGMA), rounds=3)
    torch.cuda.synchronize()
    fwd_launches = dict(L.launches)
    require(out.shape == CLIP and np.isfinite(out).all(), "residual flagship serve output")
    require(not fwd_launches, f"residual flagship forward launched {fwd_launches}")

    tc = np.stack([smooth_clip(rng, *CLIP[:2])[None] for _ in range(TRAIN_N)])
    batch = torch.from_numpy(tc).to(dev)
    opt = make_optimizer(2e-4, clip_grad=0.05)
    state = opt.init(dict(model.named_parameters()))
    train_step, _ = make_train_step(model, opt, workload="3d", noise_std=TRAIN_SIGMA)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L.launches.clear()
    loss = train_step(state, batch, gen)
    torch.cuda.synchronize()
    step_launches = dict(L.launches)
    step_ms = host_ms(lambda: train_step(state, batch, gen), rounds=2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"time [{card}]: residual flagship (K=30, M=169, P=(7,7,5), s=2, residual blocks "
          f"169->169 3^3) forward of a {CLIP} clip {fwd_ms:.3f} ms (CUDA events), "
          f"denoise_video {serve_ms:.3f} ms host clock; train step N={TRAIN_N} {step_ms:.3f} ms "
          f"(loss {float(loss):.6f}, peak {peak:.2f} GB); kernel launches {fwd_launches}, "
          f"{step_launches}", flush=True)
    require(bool(torch.isfinite(loss)) and all(torch.isfinite(p).all()
                                               for p in model.parameters()),
            "the residual train step gave a non-finite loss or parameter")
    require(not step_launches, f"the residual train step launched {step_launches}")
    del model, server, batch, state
    torch.cuda.empty_cache()


def baseline_step(model, noisy, sig, clean):
    """(loss, gradients) of one train-mode forward and backward; the
    model's running statistics move as in a training step."""
    model.train()
    loss = mse_loss(model(noisy, sig)[0], clean)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def baselines_phase(dev, card) -> None:
    """B. DnCNN (DnCNN-S width) and FFDNet (published grayscale width) on
    cuDNN, which have no hand kernel: B1 20 fit() steps on 128 crops of
    data/synthetic.natural_image (40^2 / 50^2) with finite, falling losses,
    moving running statistics and a checkpoint that reloads them bitwise;
    B2 the eval forward on the card against the CPU on the same weights,
    and one training step (loss, gradients, statistics) in float64 and in
    fp32, each device's fp32 gradients also against float64; B3 Denoiser on a
    481x321 image and a batch of 8 x 128^2 (latency, images/s); B4 two
    epochs of the train CLI for DnCNN and cli.analyze on its checkpoint."""
    rng = np.random.default_rng(SEED + 100)
    for name, cls, cfg in (("DnCNN", DnCNN, DNCNN_WIDTH), ("FFDNet", FFDNet, FFDNET_WIDTH)):
        crop = BASE_CROPS[name]
        clean = natural_crops(rng, BASE_BATCH, crop)
        model = cls(**cfg).to(dev).init(torch.Generator().manual_seed(SEED))
        opt = make_optimizer(1e-3)
        state = opt.init(dict(model.named_parameters()))
        loaders = {"train": [clean], "val": [clean[:8]], "test": [clean[:8]]}
        with tempfile.TemporaryDirectory() as save_dir:
            t0 = time.perf_counter()
            state, history = fit(model, opt, state, loaders, save_dir=save_dir,
                                 epochs=FIT_STEPS, noise_std=SIGMA, val_freq=10, save_freq=10,
                                 backtrack_thresh=None, verbose=False, seed=SEED,
                                 workload="2d")
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            losses = [10 ** (-p / 10) for _, ph, p in history if ph == "train"]
            print(f"baselines {name}: fit {FIT_STEPS} steps of {BASE_BATCH}x{crop}^2 in "
                  f"{fit_s:.2f} s; train losses {[f'{v:.6f}' for v in losses]}", flush=True)
            require(len(losses) == FIT_STEPS and all(np.isfinite(losses)),
                    f"{name}: non-finite or missing train losses {losses}")
            require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                    f"{name}: losses did not fall: {losses[:5]} .. {losses[-5:]}")
            require(not torch.equal(model.bn_mean, torch.zeros_like(model.bn_mean))
                    and not torch.equal(model.bn_var, torch.ones_like(model.bn_var)),
                    f"{name}: fit did not move the running statistics")
            back = cls(**cfg).to(dev)
            _, _, epoch, _ = load_ckpt(os.path.join(save_dir, "net.ckpt.npz"), back)
            require(epoch == FIT_STEPS and all(
                torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                  model.state_dict().values())),
                f"{name}: fit's checkpoint did not reload its params and statistics")
        batch = torch.from_numpy(clean).to(dev)
        step, _ = make_train_step(model, opt, workload="2d", noise_std=SIGMA)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_ms = host_ms(lambda: step(state, batch, gen), rounds=5)
        peak = torch.cuda.max_memory_allocated() / 1e9

        # B2. the card against the CPU on the same weights: eval forward and
        # one training step
        cpu = cls(**cfg)
        cpu.load_state_dict(model.state_dict())
        model.eval(), cpu.eval()
        big_clean, big_noisy = noisy_images(rng, BIG_IMAGE, [SIGMA])
        with torch.no_grad():
            got = model(torch.from_numpy(big_noisy).to(dev), SIGMA)[0]
            ref = cpu(torch.from_numpy(big_noisy), SIGMA)[0]
        d_fwd, rel_fwd = rel_err(got.cpu(), ref)
        noisy = (clean[:BASE_PARITY_N] + SIGMA / 255 * rng.standard_normal(
            (BASE_PARITY_N, 1, crop, crop)).astype(np.float32))
        pair = [torch.from_numpy(a) for a in (noisy, clean[:BASE_PARITY_N])]

        def one_step(device, dtype):
            m = cls(**cfg).to(device, dtype)
            m.load_state_dict(model.state_dict())
            loss, grads = baseline_step(m, pair[0].to(device, dtype), SIGMA,
                                        pair[1].to(device, dtype))
            return (loss.double().cpu(), [g.double().cpu() for g in grads],
                    [m.bn_mean.double().cpu(), m.bn_var.double().cpu()])

        steps = {(d, dt): one_step(d, dt) for d in (dev, "cpu")
                 for dt in (torch.float64, torch.float32)}

        def step_errs(a, b):
            (la, ga, sa), (lb, gb, sb) = steps[a], steps[b]
            return (float((la - lb).abs() / lb.abs()), max(rel_err(x, y)[1] for x, y in
                                                            zip(ga, gb)),
                    max(rel_err(x, y)[1] for x, y in zip(sa, sb)))

        f64 = step_errs((dev, torch.float64), ("cpu", torch.float64))
        f32 = step_errs((dev, torch.float32), ("cpu", torch.float32))
        card_exact = step_errs((dev, torch.float32), ("cpu", torch.float64))[1]
        cpu_exact = step_errs(("cpu", torch.float32), ("cpu", torch.float64))[1]
        print(f"baselines {name}: card vs CPU forward at {BIG_IMAGE} max|d| {d_fwd:.3e} "
              f"rel {rel_fwd:.3e}; one step of {BASE_PARITY_N}x{crop}^2 in float64: loss rel "
              f"{f64[0]:.3e}, gradients rel {f64[1]:.3e}, running statistics rel "
              f"{f64[2]:.3e}; in fp32: loss {f32[0]:.3e}, gradients {f32[1]:.3e}, statistics "
              f"{f32[2]:.3e}, fp32 gradients against float64 on the card {card_exact:.3e}, "
              f"on the CPU {cpu_exact:.3e}", flush=True)
        require(rel_fwd <= BASE_FWD_TOL, f"{name} forward card vs CPU rel {rel_fwd:.3e}")
        require(f64[0] <= BASE_STEP_TOL and f64[1] <= BASE_STEP_TOL and f64[2] <= BASE_FWD_TOL,
                f"{name} float64 step card vs CPU: loss, gradients, statistics {f64}")
        require(f32[0] <= BASE_STEP_TOL and f32[2] <= BASE_FWD_TOL,
                f"{name} fp32 step card vs CPU: loss {f32[0]:.3e}, statistics {f32[2]:.3e}")
        del cpu, steps

        # B3. serving through Denoiser: a 481x321 image and a batch of 8 x 128^2
        server = Denoiser(model)
        b_clean, b_noisy = noisy_images(rng, IMAGE, [SIGMA] * THROUGHPUT_BATCH)
        out = server.denoise_image(big_noisy[0, 0], sigma=SIGMA)
        outs = server.denoise_image_batch(b_noisy, sigmas=[SIGMA] * THROUGHPUT_BATCH)
        blind = server.denoise_image(big_noisy[0, 0])
        require(out.shape == BIG_IMAGE and np.isfinite(out).all() and np.isfinite(blind).all()
                and outs.shape == b_noisy.shape and np.isfinite(outs).all(),
                f"{name}: misshapen or non-finite Denoiser output")
        lat = host_ms(lambda: server.denoise_image(big_noisy[0, 0], sigma=SIGMA))
        b_ms = host_ms(lambda: server.denoise_image_batch(
            b_noisy, sigmas=[SIGMA] * THROUGHPUT_BATCH))
        yb = torch.from_numpy(np.pad(big_noisy, [(0, 0), (0, 0), (0, 63), (0, 31)],
                                     mode="reflect")).to(dev)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(yb, SIGMA), reps=3)
        gain = psnr(out, big_clean[0, 0]) - psnr(big_noisy[0, 0], big_clean[0, 0])
        print(f"time [{card}]: {name} ({cfg}) train step {BASE_BATCH}x{crop}^2 "
              f"{step_ms:.3f} ms (peak {peak:.2f} GB); 481x321 image {lat:.3f} ms through "
              f"denoise_image (forward {fwd_ms:.3f} ms at 384x512, CUDA events), batch of "
              f"{THROUGHPUT_BATCH} x 128^2 {b_ms:.3f} ms = "
              f"{1e3 * THROUGHPUT_BATCH / b_ms:.1f} images/s; after {FIT_STEPS} steps its "
              f"gain at sigma 25 {gain:.3f} dB", flush=True)
        del server, model, state, batch, opt
        torch.cuda.empty_cache()

    # B4. two epochs of the train CLI (DnCNN on image directories, on the
    # card by default), then the eval CLI on the checkpoint it saved
    with tempfile.TemporaryDirectory() as root:
        data = gen_natural_image_dirs(os.path.join(root, "data"), n_train=CLI_TRAIN_IMAGES,
                                      n_test=CLI_TEST_IMAGES, seed=SEED)
        save_dir = os.path.join(root, "run")
        args = {"type": "DnCNN", "model": dict(DNCNN_WIDTH), "paths": {"save": save_dir},
                "train": {"opt": {"lr": 1e-3},
                          "fit": {"epochs": CLI_EPOCHS, "noise_std": SIGMA, "val_freq": 1,
                                  "save_freq": 1, "backtrack_thresh": None,
                                  "verbose": False, "clip_grad": None},
                          "loaders": {"crop_size": BASE_CROPS["DnCNN"],
                                      "batch_size": [TRAIN_2D_N, 1, 1], **{
                                          f"{k}_path_list": [os.path.join(data, split)]
                                          for k, split in (("trn", "train"), ("val", "val"),
                                                           ("tst", "test"))}}}}
        t0 = time.perf_counter()
        cli_state, history = cli_train.main(args)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        require([(e, ph) for e, ph, _ in history]
                == [(1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]
                and all(np.isfinite(p) for _, _, p in history),
                f"the DnCNN train CLI's history {history}")
        with open(os.path.join(save_dir, "args.json")) as f:
            saved = json.load(f)
        t0 = time.perf_counter()
        analyze.main(build_argparser().parse_args(
            ["args.json", "--test", os.path.join(data, "test"), "--noise_level", "25"]), saved)
        eval_s = time.perf_counter() - t0
        with open(os.path.join(save_dir, "test_test_None.txt")) as f:
            line = f.read()
        sigma, p = line.strip().split(", ")
        print(f"baselines: DnCNN train CLI {cli_s:.2f} s for {CLI_EPOCHS} epochs "
              f"(PSNR {[(e, ph, round(v, 3)) for e, ph, v in history]}), cli.analyze "
              f"{eval_s:.2f} s on {CLI_TEST_IMAGES} test images: {line.strip()!r}", flush=True)
        require(sigma == "25" and np.isfinite(float(p)) and cli_state["count"] > 0,
                f"cli.analyze on the DnCNN checkpoint wrote {line!r}")


def ckpt_phase(dev, card) -> dict:
    """K. Reference torch .ckpt files on the kernels: K1 the video, 2D
    flagship and CSR demos exported by save_torch_checkpoint and served
    through Denoiser.from_args from the .ckpt, bitwise the .npz route with
    the same launches and a PSNR gain >= 3 dB; K2 the flagship video model
    resumed for 5 fit() steps from a .ckpt holding Adam state, bitwise the
    losses and weights of a resume from an .npz bundle of the same state;
    K3 fit(ckpt_format="orbax") for two epochs, whose promoted .npz reloads
    equal. Returns the kernel launches."""
    rng = np.random.default_rng(SEED + 110)
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as root:
        for demo in (DEMO, DEMO_2D, CSR_DEMO):
            npz = Denoiser.from_dir(demo)
            path = os.path.join(root, os.path.basename(demo) + ".ckpt")
            t0 = time.perf_counter()
            save_torch_checkpoint(path, npz.model, epoch=1)
            save_ms = 1e3 * (time.perf_counter() - t0)
            with open(os.path.join(demo, "args.json")) as f:
                args = json.load(f)
            args["paths"] = {"ckpt": path}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck = Denoiser.from_args(args)
            torch.cuda.synchronize()
            load_ms = 1e3 * (time.perf_counter() - t0)
            if demo == DEMO_2D:
                clean, noisy = (a[0, 0] for a in noisy_images(rng, IMAGE, [SIGMA]))
                serve = {label: (lambda d=d: d.denoise_image(noisy, sigma=SIGMA))
                         for label, d in (("npz", npz), ("ckpt", ck))}
            else:
                clean = smooth_clip(rng, CSR_DEPTH if demo == CSR_DEMO else CLIP[0], IMAGE)
                noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
                serve = {label: (lambda d=d: d.denoise_video(noisy, sigma=SIGMA))
                         for label, d in (("npz", npz), ("ckpt", ck))}
            outs, counts = {}, {}
            for label, fn in serve.items():
                L.launches.clear()
                outs[label] = fn()
                torch.cuda.synchronize()
                counts[label] = dict(L.launches)
                launches.update(counts[label])
            gain = psnr(outs["ckpt"], clean) - psnr(noisy, clean)
            same_w = all(torch.equal(a, b) for a, b in zip(npz.model.state_dict().values(),
                                                           ck.model.state_dict().values()))
            print(f"ckpt {os.path.basename(demo)}: save_torch_checkpoint {save_ms:.1f} ms, "
                  f"Denoiser.from_args on the .ckpt {load_ms:.1f} ms; weights equal {same_w}, "
                  f"output bitwise the .npz route's {np.array_equal(outs['npz'], outs['ckpt'])}"
                  f"; launches {counts['ckpt']}; gain {gain:.3f} dB", flush=True)
            require(same_w and np.array_equal(outs["npz"], outs["ckpt"]),
                    f"{demo}: the .ckpt route differs from the .npz route")
            require(counts["ckpt"] == counts["npz"] and sum(counts["ckpt"].values()) > 0,
                    f"{demo}: launches {counts}")
            require(gain >= MIN_GAIN_DB, f"{demo} from .ckpt: gain {gain:.3f} dB")
            del npz, ck

        # K2. the flagship video model, two steps in, resumed from a .ckpt and
        # from an .npz bundle of the same state
        model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
        model.init(torch.Generator().manual_seed(SEED))
        opt = make_optimizer(2e-4, clip_grad=0.05)
        state = opt.init(dict(model.named_parameters()))
        tc = np.stack([smooth_clip(rng, *CLIP[:2])[None] for _ in range(TRAIN_N)])
        step, _ = make_train_step(model, opt, workload="3d", noise_std=TRAIN_SIGMA)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for _ in range(2):
            step(state, torch.from_numpy(tc).to(dev), gen)
        paths = {"npz": os.path.join(root, "flagship.ckpt.npz"),
                 "ckpt": os.path.join(root, "flagship.ckpt")}
        t0 = time.perf_counter()
        save_ckpt(paths["npz"], model, 2, state, get_lr(state))
        save_npz_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        save_torch_checkpoint(paths["ckpt"], model, epoch=2, opt_state=state)
        save_ckpt_ms = 1e3 * (time.perf_counter() - t0)
        runs, load_ms, counts = {}, {}, {}
        loaders = {"train": [tc], "val": [tc], "test": [tc]}
        for label, path in paths.items():
            args = {"type": "CDLNetVideo", "model": dict(FLAGSHIP, backend="pallas"),
                    "paths": {"ckpt": path},
                    "train": {"opt": {"lr": 1e-3}, "fit": {"clip_grad": 0.05}}}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, o, st, epoch0, _ = init_model(args)
            torch.cuda.synchronize()
            load_ms[label] = 1e3 * (time.perf_counter() - t0)
            require(epoch0 == 2 and st["count"] == 2 and get_lr(st) == get_lr(state)
                    and all(torch.equal(st["mu"][k], state["mu"][k]) for k in state["mu"]),
                    f"init_model on the {label} did not restore the Adam state")
            L.launches.clear()
            with tempfile.TemporaryDirectory() as save_dir:
                st, hist = fit(m, o, st, loaders, save_dir=save_dir, epochs=RESUME_STEPS,
                               start_epoch=epoch0 + 1, noise_std=TRAIN_SIGMA, val_freq=100,
                               save_freq=100, backtrack_thresh=None, verbose=False, seed=SEED)
            torch.cuda.synchronize()
            counts[label] = dict(L.launches)
            launches.update(counts[label])
            runs[label] = ([p for _, ph, p in hist if ph == "train"], m)
        same_w = all(torch.equal(a, b) for a, b in zip(runs["npz"][1].parameters(),
                                                       runs["ckpt"][1].parameters()))
        print(f"ckpt flagship resume: save .npz {save_npz_ms:.1f} ms, .ckpt {save_ckpt_ms:.1f}"
              f" ms; init_model from .npz {load_ms['npz']:.1f} ms, from .ckpt "
              f"{load_ms['ckpt']:.1f} ms (host clock, {card}); {RESUME_STEPS} steps' PSNRs "
              f"{runs['ckpt'][0]} bitwise the .npz resume's {runs['npz'][0] == runs['ckpt'][0]}"
              f", weights {same_w}; launches {counts['ckpt']}", flush=True)
        require(len(runs["ckpt"][0]) == RESUME_STEPS and runs["npz"][0] == runs["ckpt"][0]
                and same_w and counts["npz"] == counts["ckpt"],
                "the .ckpt resume differs from the .npz resume")

        # K3. fit(ckpt_format="orbax"): background saves, promoted .npz
        m = runs["ckpt"][1]
        st = opt.init(dict(m.named_parameters()))
        save_dir = os.path.join(root, "orbax")
        L.launches.clear()
        t0 = time.perf_counter()
        st, hist = fit(m, opt, st, loaders, save_dir=save_dir, epochs=2, noise_std=TRAIN_SIGMA,
                       backtrack_thresh=None, verbose=False, seed=SEED, ckpt_format="orbax")
        fit_s = time.perf_counter() - t0
        launches.update(L.launches)
        files = sorted(os.listdir(save_dir))
        back = CDLNetVideo(**FLAGSHIP).to(dev)
        back_state = opt.init(dict(back.named_parameters()))
        _, back_state, epoch, _ = load_ckpt(os.path.join(save_dir, "net.ckpt.npz"), back,
                                            back_state)
        t0 = time.perf_counter()
        save_ckpt(os.path.join(root, "bg"), m, 2, st, get_lr(st), background=True)
        bg_ms = 1e3 * (time.perf_counter() - t0)
        load_ckpt(os.path.join(root, "bg"), back)
        print(f"ckpt orbax: fit 2 epochs in {fit_s:.2f} s left {files}; a background save "
              f"returns in {bg_ms:.1f} ms (the synchronous one {save_npz_ms:.1f} ms)",
              flush=True)
        require("net.ckpt.npz" in files and not [f for f in files if f.endswith(".new")]
                and epoch == 2 and back_state["count"] == st["count"] == 2
                and all(torch.equal(a, b) for a, b in zip(back.parameters(), m.parameters())),
                f"fit(ckpt_format='orbax') left {files}, epoch {epoch}")
        del model, runs, m, back
    torch.cuda.empty_cache()
    return dict(launches)


class SpanDenoiser:
    """One server's Denoiser for images (the flagship 2D demo) and clips (the
    video demo), with a CUDA event recorded on the calling thread's current
    stream before and after each call: the calls' spans on the device's
    timeline."""

    def __init__(self, image, video):
        self.image, self.video = image, video
        self.model, self.device = image.model, image.device
        self.blind, self.bucket = image.blind, image.bucket
        self.spans = []  # (call, thread, stream, start event, end event)

    def _span(self, call, fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        self.spans.append((call, threading.current_thread().name,
                           torch.cuda.current_stream().cuda_stream, a, b))
        return out

    def denoise_image_batch(self, imgs, sigmas=None):
        return self._span("image batch", lambda: self.image.denoise_image_batch(imgs, sigmas))

    def denoise_image(self, img, sigma=None):
        return self._span("image", lambda: self.image.denoise_image(img, sigma=sigma))

    def denoise_video(self, clip, sigma=None, **kw):
        return self._span("video", lambda: self.video.denoise_video(clip, sigma=sigma, **kw))


def http_post(port, path, arr, **query):
    """A .npy POST to the server on 127.0.0.1:port: (status, the .npy
    answer or the error's JSON)."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr, np.float32))
    q = "&".join(f"{k}={v}" for k, v in query.items())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}" + (f"?{q}" if q else ""),
                                 data=buf.getvalue(), method="POST",
                                 headers={"Content-Type": "application/x-npy"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, np.load(io.BytesIO(r.read()), allow_pickle=False)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def traffic(port, requests, threads):
    """POST (path, array, query) requests from `threads` client threads at
    once: (answers, per-request host ms, wall s)."""
    def one(req):
        path, arr, query = req
        t0 = time.perf_counter()
        status, out = http_post(port, path, arr, **query)
        require(status == 200, f"{path} {query}: {status} {out}")
        return out, 1e3 * (time.perf_counter() - t0)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        done = list(ex.map(one, requests))
    return [o for o, _ in done], [ms for _, ms in done], time.perf_counter() - t0


def batch_delta(before, after) -> dict:
    """The coalesced batch sizes /metrics counted between two snapshots."""
    return {int(k): v - before.get(k, 0) for k, v in after.items() if v > before.get(k, 0)}


def read_listening(proc, timeout_s):
    """The port of a server subprocess's "listening on http://host:port"
    line, read from its stdout within timeout_s."""
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            ln = lines.get(timeout=1.0)
        except queue.Empty:
            require(proc.poll() is None, f"the server exited with {proc.returncode}")
            continue
        m = re.search(r"listening on http://[\d.]+:(\d+)", ln)
        if m:
            return int(m.group(1))
    raise RuntimeError(f"chip_smoke: no listening line from the server in {timeout_s} s")


def server_phase(dev, card) -> dict:
    """S. The HTTP front end (cdlnet_tpu_torch/server.py) on the card: S1 the
    trained flagship 2D demo behind DenoiseServer on 127.0.0.1, 32
    concurrent 128^2 requests at mixed sigma from 8 client threads, each
    within 1e-4 of denoise_image on the same image, their launches one
    K + K forward per coalesced batch, requests/s, p50/p99 and the /metrics
    batch sizes, then the same at max_batch 1; a blind request; a 400 for a
    bad body; a 481x321 image and a video-demo clip through the server
    against the same calls on the Denoisers (the clip bitwise), the gap
    being the HTTP and .npy cost; coalesced image batches (the coalescer's
    thread) and clips and image stacks (handler threads) on one device lock,
    their spans on the card's timeline disjoint. S2 `python -m
    cdlnet_tpu_torch.server` in a subprocess: its listening line, one
    image, stopped. Returns the kernel launches."""
    rng = np.random.default_rng(SEED + 120)
    launches = collections.Counter()
    image_d, video_d = Denoiser.from_dir(DEMO_2D), Denoiser.from_dir(DEMO)
    require(image_d.device.type == "cuda", "Denoiser.from_dir did not default to the card")
    K2, K3 = image_d.model.K, video_d.model.K
    sigmas = [float(s) for s in rng.uniform(*DEMO_2D_SIGMAS, SERVER_REQUESTS)]
    clean, noisy = noisy_images(rng, IMAGE, sigmas)
    imgs = [noisy[i, 0] for i in range(SERVER_REQUESTS)]
    singles = [image_d.denoise_image(im, sigma=s) for im, s in zip(imgs, sigmas)]
    clip_clean = smooth_clip(rng, *CLIP[:2])
    clip = clip_clean + SIGMA / 255 * rng.standard_normal(clip_clean.shape).astype(np.float32)
    _, big = noisy_images(rng, BIG_IMAGE, [SIGMA])
    big = big[0, 0]
    figures = {}
    span_d = SpanDenoiser(image_d, video_d)
    for max_batch in (8, 1):
        srv = DenoiseServer(span_d, host="127.0.0.1", port=0, max_batch=max_batch).start()
        try:
            port = srv.port
            reqs = [("/v1/denoise_image", im, {"sigma": s}) for im, s in zip(imgs, sigmas)]
            traffic(port, reqs[:SERVER_THREADS], SERVER_THREADS)  # warm the batch shapes
            before = http_get(port, "/metrics")["coalesced_batch_sizes"]
            L.launches.clear()
            outs, lat, wall = traffic(port, reqs, SERVER_THREADS)
            torch.cuda.synchronize()
            counts = dict(L.launches)
            launches.update(counts)
            hist = batch_delta(before, http_get(port, "/metrics")["coalesced_batch_sizes"])
            d_max = max(float(np.abs(o - ref).max()) for o, ref in zip(outs, singles))
            forwards = sum(hist.values()) if max_batch > 1 else SERVER_REQUESTS
            figures[max_batch] = (SERVER_REQUESTS / wall, np.percentile(lat, 50),
                                  np.percentile(lat, 99), hist)
            print(f"server [{card}]: {SERVER_REQUESTS} concurrent {IMAGE[0]}x{IMAGE[1]} "
                  f"requests at sigma {min(sigmas):.1f}..{max(sigmas):.1f} from "
                  f"{SERVER_THREADS} threads, max_batch {max_batch}: "
                  f"{SERVER_REQUESTS / wall:.1f} requests/s, p50 {figures[max_batch][1]:.3f} "
                  f"ms, p99 {figures[max_batch][2]:.3f} ms (host clock); coalesced batch "
                  f"sizes {hist}; launches {counts}; max|d| vs denoise_image {d_max:.3e}",
                  flush=True)
            require(d_max <= 1e-4, f"served images differ from denoise_image by {d_max:.3e}")
            want = {"lista2d_ana_threshold": K2 * forwards, "lista2d_syn_residual": K2 * forwards}
            require(counts == want, f"max_batch {max_batch}: launches {counts}, expected {want}")
            require(max_batch > 1 or not hist, f"max_batch 1 coalesced {hist}")
            if max_batch == 1:
                continue

            # the blind request (sigma estimated per image) and a bad body
            status, blind = http_post(port, "/v1/denoise_image", imgs[0])
            d_blind = float(np.abs(blind - image_d.denoise_image(imgs[0])).max())
            gain = psnr(blind, clean[0, 0]) - psnr(imgs[0], clean[0, 0])
            status_bad, err = http_post(port, "/v1/denoise_image", np.zeros((2, 2, 2, 2, 2)))
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/denoise_image",
                                         data=b"junk", method="POST")
            try:
                urllib.request.urlopen(req, timeout=60)
                status_junk = 200
            except urllib.error.HTTPError as e:
                status_junk = e.code
            print(f"server: blind request max|d| vs denoise_image {d_blind:.3e}, gain "
                  f"{gain:.3f} dB; a 5-D image {status_bad} ({err['error']}), a body that is "
                  f"not .npy {status_junk}", flush=True)
            require(status == 200 and d_blind <= 1e-4 and gain >= MIN_GAIN_DB,
                    f"blind request: {status}, max|d| {d_blind:.3e}, gain {gain:.3f} dB")
            require(status_bad == status_junk == 400, f"bad bodies: {status_bad}, {status_junk}")

            # one 481x321 image and one clip: through the server and direct
            L.launches.clear()
            status, out_clip = http_post(port, "/v1/denoise_video", clip, sigma=SIGMA)
            torch.cuda.synchronize()
            counts = dict(L.launches)
            launches.update(counts)
            direct = video_d.denoise_video(clip, sigma=SIGMA)
            require(status == 200 and np.array_equal(out_clip, direct),
                    f"the served clip is not denoise_video's: {status}")
            require(counts == {"lista3d_ana_threshold": K3, "lista3d_syn_residual": K3},
                    f"the served clip launched {counts}")
            status, out_big = http_post(port, "/v1/denoise_image", big, sigma=SIGMA)
            d_big = float(np.abs(out_big - image_d.denoise_image(big, sigma=SIGMA)).max())
            require(status == 200 and d_big <= 1e-4, f"481x321: {status}, max|d| {d_big:.3e}")
            gap = {}
            for label, via, fn in (
                (f"{BIG_IMAGE[1]}x{BIG_IMAGE[0]} image",
                 lambda: http_post(port, "/v1/denoise_image", big, sigma=SIGMA),
                 lambda: image_d.denoise_image(big, sigma=SIGMA)),
                (f"video-demo clip {CLIP}",
                 lambda: http_post(port, "/v1/denoise_video", clip, sigma=SIGMA),
                 lambda: video_d.denoise_video(clip, sigma=SIGMA)),
            ):
                gap[label] = (host_ms(via), host_ms(fn))
                print(f"time [{card}]: {label} through the server {gap[label][0]:.3f} ms, "
                      f"the Denoiser call {gap[label][1]:.3f} ms (host clock, median of 5): "
                      f"HTTP and .npy {gap[label][0] - gap[label][1]:.3f} ms", flush=True)

            # coalesced batches (the coalescer's thread) beside clips and image
            # stacks (handler threads), all on one device lock
            span_d.spans.clear()
            mixed = []
            for i in range(3 * SERVER_THREADS):
                if i % 4 == 0:
                    mixed.append(("/v1/denoise_video", clip, {"sigma": SIGMA}))
                elif i % 4 == 1:
                    mixed.append(("/v1/denoise_image", noisy[:2], {"sigma": SIGMA}))
                else:
                    mixed.append(("/v1/denoise_image", imgs[i], {"sigma": sigmas[i]}))
            traffic(port, mixed, SERVER_THREADS)
            torch.cuda.synchronize()
            ref = span_d.spans[0][3]
            spans = sorted((ref.elapsed_time(a), ref.elapsed_time(b), call, thread, stream)
                           for call, thread, stream, a, b in span_d.spans)
            overlaps = sum(s[0] < p[1] for p, s in zip(spans, spans[1:]))
            threads = {s[3] for s in spans}
            print(f"server: {len(spans)} device calls of {sorted({s[2] for s in spans})} from "
                  f"{len(threads)} threads (the coalescer's: "
                  f"{sum('_loop' in t for t in threads)}) on streams "
                  f"{sorted({s[4] for s in spans})}; overlapping spans on the card's "
                  f"timeline: {overlaps}", flush=True)
            require(len(threads) > 1 and {s[2] for s in spans}
                    >= {"image batch", "image", "video"} and overlaps == 0,
                    f"device spans: {len(spans)} calls, {overlaps} overlapping")
        finally:
            srv.stop()
    (rps8, p50_8, p99_8, hist8), (rps1, p50_1, p99_1, _) = figures[8], figures[1]
    print(f"server [{card}]: max_batch 8 vs 1: {rps8:.1f} vs {rps1:.1f} requests/s, p50 "
          f"{p50_8:.3f} vs {p50_1:.3f} ms, p99 {p99_8:.3f} vs {p99_1:.3f} ms; batch sizes "
          f"{hist8}", flush=True)

    # S2. the entry point as users start it, in processes of its own (the
    # default max_batch 8, and 1): one image each, then the same traffic,
    # whose clients no longer share the server's interpreter lock
    t0 = time.perf_counter()
    cmds = {8: SERVE_CMD, 1: SERVE_CMD + ["--max-batch", "1"]}
    with tempfile.TemporaryFile("w+") as errf:
        procs = {mb: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=errf,
                                      text=True) for mb, cmd in cmds.items()}
        try:
            ports = {mb: read_listening(proc, 300) for mb, proc in procs.items()}
            up_s = time.perf_counter() - t0
            for mb, port in ports.items():
                status, out = http_post(port, "/v1/denoise_image", imgs[0], sigma=sigmas[0])
                d_sub = float(np.abs(out - singles[0]).max()) if status == 200 else float("inf")
                require(status == 200 and d_sub <= 1e-4,
                        f"the server process (max_batch {mb}): {status}, {d_sub:.3e}")
                reqs = [("/v1/denoise_image", im, {"sigma": s}) for im, s in zip(imgs, sigmas)]
                traffic(port, reqs[:SERVER_THREADS], SERVER_THREADS)
                before = http_get(port, "/metrics")["coalesced_batch_sizes"]
                outs, lat, wall = traffic(port, reqs, SERVER_THREADS)
                hist = batch_delta(before, http_get(port, "/metrics")["coalesced_batch_sizes"])
                d_max = max(float(np.abs(o - ref).max()) for o, ref in zip(outs, singles))
                print(f"server [{card}]: {' '.join(cmds[mb][1:])} (its own process, up in "
                      f"{up_s:.2f} s): one image max|d| {d_sub:.3e}; {SERVER_REQUESTS} "
                      f"concurrent requests from {SERVER_THREADS} threads "
                      f"{SERVER_REQUESTS / wall:.1f} requests/s, p50 "
                      f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms "
                      f"(host clock); coalesced batch sizes {hist}; max|d| vs denoise_image "
                      f"{d_max:.3e}", flush=True)
                require(d_max <= 1e-4, f"the server process: max|d| {d_max:.3e}")
        except BaseException:
            for proc in procs.values():
                proc.kill()
                proc.wait(timeout=30)
            errf.seek(0)
            print(errf.read()[-4000:], file=sys.stderr)
            raise
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.terminate()
                    proc.wait(timeout=30)
    print(f"server: the server processes stopped (exit {[p.returncode for p in procs.values()]})",
          flush=True)
    del image_d, video_d, span_d
    torch.cuda.empty_cache()
    return dict(launches)


def grad_and_launches(model, names, loss_fn):
    """(loss, gradients of `names`, launches) of loss_fn(model)."""
    L.launches.clear()
    loss = loss_fn(model)
    prm = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, [prm[n] for n in names])
    torch.cuda.synchronize()
    return loss.detach(), grads, dict(L.launches)


def losses_phase(dev, card, t_par) -> dict:
    """L. MC-SURE and the combined loss on the kernels: L1 the flagship 2D
    (10 x 128^2) and video (2 x 16x128^2) MC-SURE loss and gradients on the
    kernels and on backend "xla" against "xla" in float64, two backward runs bitwise
    equal and equal to the passes run in the other order, with twice an mse
    step's launches: the loss within GRAD_TOL of the float64 plain loop's,
    each gradient within MCSURE_GRAD_TOL of it; L2 20 fit(mcsure=True) steps
    of the 2D flagship with finite, falling losses and a PSNR gain on
    held-out noise; L3 a combmse video step with seeded VGG16 weights at a
    temporary path and without them (warned, finite), the loss on the card
    against the CPU's on the same output; step ms and peak GB of each step
    beside the mse step's. Returns the kernel launches."""
    rng = np.random.default_rng(SEED + 130)
    launches = collections.Counter()
    flag2 = random_2d_model(FLAGSHIP_2D, dev)
    flag3 = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev).init(
        torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        flag3.t.copy_(t_par)
    clean2 = natural_crops(rng, TRAIN_2D_N, CROP)
    clean3 = np.stack([smooth_clip(rng, *CLIP[:2])[None] for _ in range(TRAIN_N)])
    opt = make_optimizer(FIT_2D_LR, clip_grad=FIT_2D_CLIP)
    for label, model, clean, mse_launches in (
        (f"2D flagship {TRAIN_2D_N}x{CROP}^2", flag2, clean2, step_launches_2d(flag2.K)),
        (f"video flagship {TRAIN_N}x{CLIP}", flag3, clean3, STEP_LAUNCHES),
    ):
        obs, sig = (observed if clean.ndim == 4 else observed_3d)(rng, clean, dev)
        clean_t = torch.from_numpy(clean).to(dev)
        b = torch.randn(obs.shape, generator=torch.Generator().manual_seed(SEED)).to(dev)
        plain = copy.deepcopy(model)
        plain.backend = "xla"
        names = [n for n, _ in model.named_parameters()
                 if n not in getattr(model, "unused_params", ())]
        plain64 = copy.deepcopy(plain).double()

        def sure(m, dtype=torch.float32):
            o, sg, bb = obs.to(dtype), sig.to(dtype), b.to(dtype)
            return mcsure_loss(lambda v: m(v, sg)[0], o, sg, b=bb)

        def sure_swapped(m, h=1e-3):  # mcsure_loss's sums, the perturbed pass first
            xb = m(obs + h * b, sig)[0]
            x = m(obs, sig)[0]
            return torch.mean((obs - x) ** 2) + 2.0 * torch.mean((sig / 255.0) ** 2 * b
                                                                 * (xb - x)) / h

        loss1, g1, counts = grad_and_launches(model, names, sure)
        loss2, g2, _ = grad_and_launches(model, names, sure)
        _, gs, _ = grad_and_launches(model, names, sure_swapped)
        lossp, gp, _ = grad_and_launches(plain, names, sure)
        loss64, g64, _ = grad_and_launches(plain64, names, lambda m: sure(m, torch.float64))
        launches.update(counts)
        want = {k: 2 * v for k, v in mse_launches.items()}
        rel_loss = rel_err(loss1.double(), loss64)[1]
        print(f"losses: {label} MC-SURE loss {float(loss1):.6f} (xla {float(lossp):.6f}, "
              f"float64 {float(loss64):.6f}; kernels vs float64 rel {rel_loss:.3e}); launches "
              f"{counts}", flush=True)
        require(counts == want, f"{label} MC-SURE: launches {counts}, expected {want}")
        require(rel_loss <= GRAD_TOL and torch.equal(loss1, loss2),
                f"{label} MC-SURE loss rel err {rel_loss:.3e}")
        for name, a, a2, a_s, ref, ref64 in zip(names, g1, g2, gs, gp, g64):
            rel_k, rel_x = rel_err(a.double(), ref64)[1], rel_err(ref.double(), ref64)[1]
            print(f"parity {label} MC-SURE gradient d{name} vs float64: kernels rel {rel_k:.3e}"
                  f", xla (fp32) rel {rel_x:.3e}, kernels vs xla rel {rel_err(a, ref)[1]:.3e}; "
                  f"two runs bitwise equal: {torch.equal(a, a2)}, the passes swapped: "
                  f"{torch.equal(a, a_s)}", flush=True)
            require(rel_k <= MCSURE_GRAD_TOL,
                    f"{label} MC-SURE d{name} rel err {rel_k:.3e} > {MCSURE_GRAD_TOL}")
            require(torch.equal(a, a2) and torch.equal(a, a_s),
                    f"{label} MC-SURE: two backward runs, or the passes swapped, differ in "
                    f"d{name}")
        del plain, plain64, g1, g2, gs, gp, g64
        # the step on the kernels: mse and MC-SURE (host clock, peak memory)
        st = opt.init(dict(model.named_parameters()))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        times = {}
        for loss_label, kw in (("mse", {}), ("MC-SURE", {"mcsure": True})):
            step, _ = make_train_step(model, opt, workload="2d" if clean.ndim == 4 else "3d",
                                      noise_std=TRAIN_SIGMA, **kw)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            times[loss_label] = (host_ms(lambda: step(st, clean_t, gen)),
                                 torch.cuda.max_memory_allocated() / 1e9)
        print(f"time [{card}]: {label} train step, mse {times['mse'][0]:.3f} ms (peak "
              f"{times['mse'][1]:.2f} GB), MC-SURE {times['MC-SURE'][0]:.3f} ms (peak "
              f"{times['MC-SURE'][1]:.2f} GB)", flush=True)
    del flag3

    # L2. fit(mcsure=True) on the 2D flagship from the power-method init
    fit_model = CDLNet(**FLAGSHIP_2D, backend="pallas").to(dev).init(
        torch.Generator().manual_seed(SEED))
    held_clean = natural_crops(rng, TRAIN_2D_N, CROP)
    held_noisy, held_sig = observed(rng, held_clean, dev)

    def held_out_gain():
        with torch.no_grad():
            out = fit_model(held_noisy, held_sig)[0].cpu().numpy()
        noisy = held_noisy.cpu().numpy()
        return psnr(out, held_clean) - psnr(noisy, held_clean)

    gain0 = held_out_gain()
    state = opt.init(dict(fit_model.named_parameters()))
    loaders = {"train": [clean2], "val": [clean2], "test": [clean2]}
    with tempfile.TemporaryDirectory() as save_dir:
        L.launches.clear()
        t0 = time.perf_counter()
        state, history = fit(fit_model, opt, state, loaders, save_dir=save_dir,
                             epochs=FIT_STEPS, noise_std=TRAIN_SIGMA, val_freq=10,
                             save_freq=10, backtrack_thresh=None, verbose=False, seed=SEED,
                             workload="2d", mcsure=True)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    counts = dict(L.launches)
    launches.update(counts)
    evals = sum(ph != "train" for _, ph, _ in history)
    K = fit_model.K
    want = {k: 2 * FIT_STEPS * v for k, v in step_launches_2d(K).items()}
    want["lista2d_ana_threshold"] += evals * K
    want["lista2d_syn_residual"] += evals * K
    sure_losses = [10 ** (-p / 10) for _, ph, p in history if ph == "train"]
    gain = held_out_gain()
    print(f"losses: fit(mcsure=True) {FIT_STEPS} steps of {TRAIN_2D_N}x{CROP}^2 + {evals} "
          f"evals in {fit_s:.2f} s; MC-SURE losses {[f'{v:.6f}' for v in sure_losses]}; "
          f"held-out gain {gain0:.3f} -> {gain:.3f} dB; launches {counts}", flush=True)
    require(counts == want, f"fit(mcsure=True) launched {counts}, expected {want}")
    require(len(sure_losses) == FIT_STEPS and all(np.isfinite(sure_losses)),
            f"non-finite or missing MC-SURE losses {sure_losses}")
    require(np.mean(sure_losses[-5:]) < np.mean(sure_losses[:5]),
            f"MC-SURE losses did not fall: {sure_losses[:5]} .. {sure_losses[-5:]}")
    require(gain > max(gain0, 0.0), f"held-out gain {gain0:.3f} -> {gain:.3f} dB")
    del fit_model

    # L3. a combmse video step, with seeded VGG16 weights and without them
    model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev).init(
        torch.Generator().manual_seed(SEED))
    clean_t = torch.from_numpy(clean3).to(dev)
    saved_paths = list(losses_mod._VGG_WEIGHT_PATHS)
    with tempfile.TemporaryDirectory() as root:
        g = torch.Generator().manual_seed(SEED)
        sd = {}
        for i, co, ci in VGG16_CONVS:
            fan_in = 9 * ci
            sd[f"features.{i}.weight"] = torch.randn(co, ci, 3, 3, generator=g) * (2 / fan_in) ** 0.5
            sd[f"features.{i}.bias"] = torch.zeros(co)
        path = os.path.join(root, "vgg16-397923af.pth")
        torch.save(sd, path)
        try:
            for weights, paths in (("seeded VGG16", [path]),
                                   ("no VGG16", [os.path.join(root, "none.pth")])):
                losses_mod._VGG_WEIGHT_PATHS[:] = paths
                losses_mod._load_vgg16_weights.cache_clear()
                losses_mod._warned_no_vgg = False
                st = opt.init(dict(model.named_parameters()))
                step, _ = make_train_step(model, opt, workload="3d", noise_std=TRAIN_SIGMA,
                                          loss_type="combmse")
                gen = torch.Generator(device=dev).manual_seed(SEED)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    L.launches.clear()
                    loss = float(step(st, clean_t, gen))
                    torch.cuda.synchronize()
                    counts = dict(L.launches)
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    step_ms = host_ms(lambda: step(st, clean_t, gen))
                    peak = torch.cuda.max_memory_allocated() / 1e9
                launches.update(counts)
                warned = sum("VGG16 pretrained weights not found" in str(w.message)
                             for w in caught)
                # the loss on the card against the CPU's on one output
                with torch.no_grad():
                    out = model(clean_t + 0.05 * torch.randn_like(clean_t), SIGMA)[0]
                    on_card = losses_mod.combined_loss(out, clean_t)
                    on_cpu = losses_mod.combined_loss(out.cpu(), clean_t.cpu())
                _, rel = rel_err(on_card.cpu(), on_cpu)
                print(f"losses: combmse video step ({weights}): loss {loss:.6f}, "
                      f"{warned} warning(s); launches {counts}; the loss on the card vs the "
                      f"CPU rel {rel:.3e}", flush=True)
                print(f"time [{card}]: combmse video train step ({weights}, {TRAIN_N}x{CLIP}) "
                      f"{step_ms:.3f} ms (peak {peak:.2f} GB)", flush=True)
                require(np.isfinite(loss) and counts == STEP_LAUNCHES,
                        f"combmse ({weights}): loss {loss}, launches {counts}")
                require(warned == (1 if weights == "no VGG16" else 0),
                        f"combmse ({weights}): {warned} warnings")
                require(rel <= KERNEL_TOL, f"combmse ({weights}) card vs CPU rel {rel:.3e}")
        finally:
            losses_mod._VGG_WEIGHT_PATHS[:] = saved_paths
            losses_mod._load_vgg16_weights.cache_clear()
    del model
    torch.cuda.empty_cache()
    return dict(launches)


def main() -> int:
    # --- 1. the device ---
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    # --- 2. build the kernels from the checkout's sources ---
    so, build_s = _build.build()
    _build.library()
    spills = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
              if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.2f} s -> {so.name}; ptxas: {' | '.join(spills)}", flush=True)
    # the tensor-core kernels' lines by name: with their launch bounds (3D:
    # the analysis and adjoint 256 threads and 2 blocks an SM, the synthesis
    # 512 and 1; 2D: the analyses 128 and 4, the synthesis 256 and 2; the
    # weight gradient 384 and 1) they set their occupancy
    entry = None
    tc_entries = {"lista3d_ana_mmaILb0": "lista3d_ana_mma",
                  "lista3d_ana_mmaILb1": "lista3d_ana_mma (adjoint)",
                  "lista3d_syn_mma": "lista3d_syn_mma",
                  "lista2d_ana_mmaILi0": "lista2d_ana_mma",
                  "lista2d_ana_mmaILi1": "lista2d_ana_mma (adjoint)",
                  "lista2d_ana_mmaILi2": "lista2d_ana_mma (csr)",
                  "lista2d_ana_mmaILi3": "lista2d_ana_mma (csrf2)",
                  "lista2d_ana_mmaILi4": "lista2d_ana_mma (csr adjoint)",
                  "lista2d_ana_mmaILi5": "lista2d_ana_mma (csrf2 adjoint)",
                  "lista2d_syn_mma": "lista2d_syn_mma", "lista3d_wgrad_mma": "lista3d_wgrad_mma"}
    for ln in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = next((v for k, v in tc_entries.items() if k in ln), None)
        elif entry and ("registers" in ln or "spill" in ln):
            print(f"ptxas {entry}: {ln.strip()}", flush=True)
    # their products in the machine code (cuobjdump, beside nvcc): the TF32
    # tensor-core instructions
    for fn, ins in compare_sass.disassemble(str(so)).items():
        label = next((v for k, v in tc_entries.items() if k in fn), None)
        if label:
            hmma = sum("HMMA" in i and "TF32" in i for i in ins)
            print(f"sass {label}: {hmma} HMMA TF32 of {len(ins)} instructions ({fn})", flush=True)
            require(hmma > 0, f"{fn} runs no TF32 tensor-core product")

    # --- 3. forward kernel parity at the flagship shape ---
    t0 = time.perf_counter()
    model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    model.init(torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"init: power-method flagship dictionary in {time.perf_counter() - t0:.2f} s",
          flush=True)
    K, M, s = FLAGSHIP["K"], FLAGSHIP["M"], FLAGSHIP["s"]
    clean = smooth_clip(rng, *CLIP[:2])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    y = torch.from_numpy(noisy)[None, None].to(dev)
    yp, _, _ = pre_process_3d(y, s)
    # thresholds > 0 so the soft threshold is exercised (the init's t0 is 0)
    tg = torch.Generator().manual_seed(SEED + 1)
    t_par = (torch.rand(K, 2, M, 1, 1, 1, generator=tg) * torch.tensor([0.02, 0.2])
             .reshape(1, 2, 1, 1, 1, 1)).to(dev)
    c = SIGMA / 255
    err: dict = {}
    with torch.inference_mode():
        ops = forward_parity(model.A, model.B, t_par, yp, s, c, tg, err)
        k_forward_parity(model.A, model.B, t_par, yp, s, c, f"{CLIP}")

    # --- 4. serve three flagship clips through Denoiser (the serve path) ---
    server = Denoiser(model)
    clips = [smooth_clip(rng, *CLIP[:2]) for _ in range(3)]
    clips = [x + SIGMA / 255 * rng.standard_normal(x.shape).astype(np.float32)
             for x in clips]
    L.launches.clear()
    outs = [server.denoise_video(x, sigma=SIGMA) for x in clips]
    serve_launches = dict(L.launches)
    print(f"serve: 3 flagship clips, launches {serve_launches}", flush=True)
    require(serve_launches == {"lista3d_ana_threshold": 3 * K,
                               "lista3d_syn_residual": 3 * K},
            f"expected {3 * K} launches of each kernel, got {serve_launches}")
    require(all(o.shape == CLIP and np.isfinite(o).all() for o in outs),
            "non-finite or misshapen serve output")

    # --- 5. the trained demo model: it must denoise, on kernels and plain alike ---
    demo = Denoiser.from_dir(DEMO)
    demo_plain = Denoiser.from_dir(DEMO, backend="xla")
    clean = smooth_clip(rng, *CLIP[:2])
    noisy = clean + SIGMA / 255 * rng.standard_normal(clean.shape).astype(np.float32)
    out = demo.denoise_video(noisy, sigma=SIGMA)
    out_plain = demo_plain.denoise_video(noisy, sigma=SIGMA)
    d_demo = float(np.abs(out - out_plain).max())
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    print(f"demo: PSNR noisy {p_in:.3f} dB -> denoised {p_out:.3f} dB "
          f"(gain {p_out - p_in:.3f} dB); kernel vs plain max|d| {d_demo:.3e}", flush=True)
    require(demo.device.type == "cuda", "Denoiser.from_dir did not default to the card")
    require(np.isfinite(out).all() and p_out - p_in >= MIN_GAIN_DB,
            f"demo gain {p_out - p_in:.3f} dB < {MIN_GAIN_DB} dB")
    require(d_demo <= 1e-4, f"demo kernel vs plain max|d| {d_demo:.3e} > 1e-4")

    # --- 6. serve times at the flagship shape (CUDA events, median of 5) ---
    plain_model = CDLNetVideo(**FLAGSHIP, backend="xla").to(dev)
    plain_model.load_state_dict(model.state_dict())
    yc = torch.from_numpy(clips[0])[None, None].to(dev)
    with torch.inference_mode():
        clip_ms = cuda_ms(lambda: model(yc, SIGMA), reps=3)
        clip_plain_ms = cuda_ms(lambda: plain_model(yc, SIGMA), reps=3)
        times = forward_times(model.A[1], model.B[1], ops, s, reps=20)
    serve_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        server.denoise_video(clips[0], sigma=SIGMA)
        serve_s.append(time.perf_counter() - t0)
    print(f"time [{card}]: flagship clip forward {clip_ms:.3f} ms on the kernels, "
          f"{clip_plain_ms:.3f} ms on the plain loop (backend xla); "
          f"Denoiser.denoise_video {1e3 * statistics.median(serve_s):.3f} ms host clock",
          flush=True)
    del server, demo, demo_plain, ops

    # --- 7. the 2D image serve path (serve_2d) ---
    launches_2d, times_2d = serve_2d(dev, card, err)
    times.update(times_2d)

    # --- 8. reverse kernel parity at the flagship training shape ---
    tc = np.stack([smooth_clip(rng, *CLIP[:2])[None] for _ in range(TRAIN_N)])
    sig = rng.uniform(*TRAIN_SIGMA, (TRAIN_N, 1, 1, 1, 1)).astype(np.float32)
    tn = tc + sig / 255 * rng.standard_normal(tc.shape).astype(np.float32)
    clean_t, noisy_t, sig_t = (torch.from_numpy(a).to(dev) for a in (tc, tn, sig))
    with torch.no_grad():
        tops = reverse_parity(model.A, model.B, t_par, noisy_t, sig_t, s, tg, err)
        train_times = reverse_times(model.A, model.B, tops, s, reps=10)
        (N, Cp, *grid), taps = tops["y2"].shape, tops["taps"]
        grid_line = (
            f"grid [{card}]: train shape lista3d_wgrad (row blocks, code blocks, splits) "
            f"masked {LB.wgrad_grid(N, Cp, M, grid, taps, tops['rows'])}, dense "
            f"{LB.wgrad_grid(N, Cp, M, grid, taps)}; lista3d_syn_adjoint "
            f"{_build.library().lista3d_syn_adjoint_parts(N, Cp, M, *grid, *taps)} position "
            f"blocks x {N} samples")
    del tops
    # the new kernels report their training-shape times
    for name in ("lista3d_syn_adjoint", "lista3d_wgrad"):
        times[name] = train_times[name]
    for name, tt in train_times.items():
        print(f"time [{card}]: train shape {name}: {tt['ms']:.4f} ms/call, plain "
              f"{tt['plain_ms']:.4f}, library {tt['library_ms']:.4f}, bound "
              f"{tt['bound_ms']:.4f} ({tt['bound_by']})", flush=True)
    print(grid_line, flush=True)

    # --- 9. the K=30 gradient through the kernels vs torch autograd ---
    train_model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    train_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        train_model.t.copy_(t_par)
    plain_train = CDLNetVideo(**FLAGSHIP, backend="xla").to(dev)
    plain_train.load_state_dict(train_model.state_dict())

    L.launches.clear()
    g1 = grads(train_model, noisy_t, sig_t, clean_t)
    torch.cuda.synchronize()
    require(dict(L.launches) == STEP_LAUNCHES,
            f"one gradient launched {dict(L.launches)}, expected {STEP_LAUNCHES}")
    g2 = grads(train_model, noisy_t, sig_t, clean_t)
    gp = grads(plain_train, noisy_t, sig_t, clean_t)
    torch.cuda.synchronize()
    for name, a, b, ref in zip("ABt", g1, g2, gp):
        d, rel = rel_err(a, ref)
        print(f"parity K={K} gradient d{name} (N={TRAIN_N}, {CLIP}): max|d| {d:.3e}, "
              f"rel {rel:.3e}; two runs bitwise equal: {torch.equal(a, b)}", flush=True)
        require(rel <= GRAD_TOL, f"K={K} gradient d{name} rel err {rel:.3e} > {GRAD_TOL}")
        require(torch.equal(a, b), f"two backward runs differ in d{name}")
    del g1, g2, gp

    # --- 10. fit(): the training path, FIT_STEPS steps on smooth clips ---
    fit_model = CDLNetVideo(**FLAGSHIP, backend="pallas").to(dev)
    fit_model.load_state_dict(model.state_dict())  # the init: t = 0
    # the JAX package's flagship-from-scratch setting (tools/
    # parity_train3d.py): at lr 1e-3 this width diverges within 15 steps of
    # the power-method init (fit's backtracking exists for that; this
    # fixed-length run switches it off)
    opt = make_optimizer(2e-4, clip_grad=0.05)
    state = opt.init(dict(fit_model.named_parameters()))
    loaders = {"train": [tc], "val": [tc], "test": [tc]}  # one batch a pass
    with tempfile.TemporaryDirectory() as save_dir:
        L.launches.clear()
        t0 = time.perf_counter()
        state, history = fit(fit_model, opt, state, loaders, save_dir=save_dir,
                             epochs=FIT_STEPS, noise_std=TRAIN_SIGMA, val_freq=10,
                             save_freq=10, backtrack_thresh=None, verbose=False,
                             seed=SEED)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = dict(L.launches)
        evals = sum(ph != "train" for _, ph, _ in history)
        want = {name: FIT_STEPS * n for name, n in STEP_LAUNCHES.items()}
        want["lista3d_ana_threshold"] += evals * K
        want["lista3d_syn_residual"] += evals * K
        losses = [10 ** (-p / 10) for _, ph, p in history if ph == "train"]
        print(f"fit: {FIT_STEPS} steps + {evals} evals in {fit_s:.2f} s; launches "
              f"{fit_launches}; train losses {[f'{v:.6f}' for v in losses]}", flush=True)
        require(fit_launches == want, f"fit launched {fit_launches}, expected {want}")
        require(len(losses) == FIT_STEPS and all(np.isfinite(losses)),
                f"non-finite or missing train losses {losses}")
        require(np.mean(losses[-5:]) < np.mean(losses[:5]),
                f"losses did not fall: first 5 {losses[:5]}, last 5 {losses[-5:]}")
        back = CDLNetVideo(**FLAGSHIP).to(dev)
        back_state = opt.init(dict(back.named_parameters()))
        _, back_state, epoch, _ = load_ckpt(os.path.join(save_dir, "net.ckpt.npz"),
                                            back, back_state)
        require(epoch == FIT_STEPS and back_state["count"] == FIT_STEPS
                and all(torch.equal(a, b) for a, b in
                        zip(back.parameters(), fit_model.parameters())),
                "fit's checkpoint did not reload to the trained state")
    del back, back_state

    # --- 11. train step times: kernels vs backend xla (host clock) ---
    steps = {}
    for label, m in (("kernels", train_model), ("xla", plain_train)):
        st = opt.init(dict(m.named_parameters()))
        torch.cuda.reset_peak_memory_stats()
        steps[label] = host_ms(lambda: train_update(m, opt, st, noisy_t, sig_t, clean_t))
        steps[label + " peak GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"time [{card}]: flagship train step (N={TRAIN_N}, {CLIP}, fwd + bwd + "
          f"Adam + project) {steps['kernels']:.3f} ms on the kernels "
          f"(peak {steps['kernels peak GB']:.2f} GB), {steps['xla']:.3f} ms on "
          f"backend xla (peak {steps['xla peak GB']:.2f} GB)", flush=True)

    del train_model, plain_train, fit_model, noisy_t, clean_t

    # --- 12. the 2D image training path (train_2d) ---
    launches_t2, times_t2 = train_2d(dev, card, err)
    times.update(times_t2)

    # --- 13. the native-resolution video path (bigframe) ---
    launches_bf, times_bf = bigframe(dev, card, err, model, t_par, tg, steps["kernels"])

    # --- 14. the frame-recurrent CSR path (csr) ---
    launches_csr, times_csr = csr(dev, card, err)
    times.update(times_csr)

    # --- 15. frame-recurrent CSR training (csr_train) ---
    launches_ct, times_ct, syn_p9 = csr_train(dev, card, err)
    times.update(times_ct)

    # --- 16. the input pipeline: device_prefetch (P1; the train CLI's loader
    # threads, P2, ran in bigframe B5) ---
    t0 = time.perf_counter()
    prefetch_phase(dev, card)
    t1 = time.perf_counter()

    # --- 17. blind PCA through the serve path (P3; the eval CLI's and the
    # CSR volume's ran in bigframe B4 and csr C3) ---
    launches_pca = blind_pca(dev, card, model, t_par)
    t2 = time.perf_counter()

    # --- 18. residual blocks (P4) ---
    residual_phase(dev, card)
    t3 = time.perf_counter()

    # --- 19. DnCNN and FFDNet (baselines) ---
    baselines_phase(dev, card)
    t4 = time.perf_counter()

    # --- 20. reference torch .ckpt files on the kernels (ckpt) ---
    launches_ck = ckpt_phase(dev, card)
    t5 = time.perf_counter()

    # --- 21. the HTTP front end (server) ---
    launches_srv = server_phase(dev, card)
    t6 = time.perf_counter()

    # --- 22. MC-SURE and the combined loss (losses) ---
    launches_loss = losses_phase(dev, card, t_par)
    print(f"phases: prefetch {t1 - t0:.2f} s, blind PCA {t2 - t1:.2f} s, residual "
          f"{t3 - t2:.2f} s, baselines {t4 - t3:.2f} s, ckpt {t5 - t4:.2f} s, server "
          f"{t6 - t5:.2f} s, losses {time.perf_counter() - t6:.2f} s", flush=True)

    launches = {name: serve_launches.get(name, 0) + fit_launches.get(name, 0)
                + launches_2d.get(name, 0) + launches_t2.get(name, 0)
                + launches_bf.get(name, 0) + launches_csr.get(name, 0)
                + launches_ct.get(name, 0) + launches_pca.get(name, 0)
                + launches_ck.get(name, 0) + launches_srv.get(name, 0)
                + launches_loss.get(name, 0) for name in KERNELS}
    for name in TC_KERNELS:
        tt = times[name]
        shape = "train shape" if "adjoint" in name or "wgrad" in name else "serve shape"
        print(f"time [{card}]: {shape} {name} {tt['ms']:.4f} ms/call, plain "
              f"{tt['plain_ms']:.4f}, library {tt['library_ms']:.4f}, bound "
              f"{tt['bound_ms']:.4f} ({tt['bound_by']}; 3xTF32 on the tensor cores)",
              flush=True)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": err[name], **times[name],
         **({"bigframe": times_bf[name]} if name in times_bf else {}),
         **({"csr P=9": syn_p9} if name == "lista2d_syn_residual" else {})}
        for name, (src, tpu) in KERNELS.items()
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
