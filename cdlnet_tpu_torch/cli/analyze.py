#!/usr/bin/env python3
"""Analysis CLI helpers (counterpart of the shared half of
cdlnet_tpu/cli/analyze.py): the argument parser and the noise-level
list that the video analyzer (cli/analyze3d.py) uses; --backend resolves
through cli.train.apply_backend.

The 2D analyzer itself (`python -m cdlnet_tpu.cli.analyze`: the image
PSNR sweep, filters, dictionary, passthrough and thresholds of CDLNet,
GDLNet, DnCNN and FFDNet) is not ported yet: main() raises.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("args_fn", type=str, help="Path to args.json file.")
    p.add_argument("--test", type=str, default=None)
    p.add_argument("--dictionary", action="store_true")
    p.add_argument("--passthrough", type=str, default=None)
    p.add_argument("--noise_level", type=int, nargs="*", default=[-1])
    p.add_argument("--blind", type=str, default=None, choices=["MAD", "PCA"])
    p.add_argument("--save", action="store_true")
    p.add_argument("--thresholds", action="store_true")
    p.add_argument("--filters", action="store_true")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--color", action="store_true")
    p.add_argument("--demosaic", action="store_true")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "pallas", "cuda", "xla"],
                   help="'auto' keeps a backend the config pins, else the "
                        "hand-written kernels; 'xla' is the plain PyTorch loop.")
    return p


def resolve_noise_levels(ARGS, model_args):
    """The --noise_level values; -1 (the default) takes the config's
    train.fit.noise_std."""
    nl = ARGS.noise_level
    if len(nl) == 1:
        nl = nl[0]
    if nl == -1:
        nl = model_args["train"]["fit"]["noise_std"]
    if not isinstance(nl, (range, list, tuple)):
        nl = [nl]
    return nl


def main(ARGS, model_args):
    raise NotImplementedError(
        "the 2D analysis CLI is not ported to cdlnet_tpu_torch yet (see ROADMAP.md); "
        "video models: python -m cdlnet_tpu_torch.cli.analyze3d")
