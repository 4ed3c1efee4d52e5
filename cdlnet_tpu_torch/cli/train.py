#!/usr/bin/env python3
"""Training CLI: `python -m cdlnet_tpu_torch.cli.train path/to/args.json`
(counterpart of cdlnet_tpu/cli/train.py).

Accepts the reference's args.json schema verbatim, on the card unless
main() is given device="cpu". Workloads, as the JAX CLI selects them:
  - the 2D families (CDLNet, JDD_CDLNet, GDLNet, DnCNN, FFDNet): image
    directories (data/images.get_fit_loaders), or fastMRI volumes when
    the loader args carry the fastMRI schema (a PDFS key), their slices
    in the batch dim (data/fastmri.volume_to_batch_loaders);
    train.fit.fit(workload="2d"), which trains DnCNN's and FFDNet's
    BatchNorm statistics too;
  - CDLNetVideo, with or without residual blocks (model.residual):
    fastMRI volumes with a PDFS key (workload "mri"), else video frame
    directories (data/video.get_video_fit_loaders, "3d");
  - the CSR models (CDLNet_CSR, CDLNet_CSRf2, argscsr.json-style configs):
    fastMRI volumes through the frame-recurrent trainer,
    train.fit_csr.fit_csr.
The loader args' num_workers (default 0) assembles the training batches in
that many threads (data/loader.py). Any other type raises
NotImplementedError.
"""

from __future__ import annotations

import json
from pprint import pprint

from cdlnet_tpu_torch.models.base import resolve_backend
from cdlnet_tpu_torch.utils import setup_debug

IMAGE_FAMILIES = ("CDLNet", "GDLNet", "JDD_CDLNet", "DnCNN", "FFDNet")
CSR_FAMILIES = ("CDLNet_CSR", "CDLNet_CSRf2")


def make_loaders(args: dict):
    """(loaders, workload) for an args dict: the image-directory loaders of
    the 2D families ("2d"), the video clip loaders of CDLNetVideo ("3d"),
    and the fastMRI volume loaders when the loader args carry a PDFS key or
    the model is a CSR one: slices in the batch dim for the 2D families
    ("2d"), volumes otherwise ("mri"). Other families raise."""
    loaders_args = dict(args["train"]["loaders"])
    mtype = args["type"]
    if mtype not in (*IMAGE_FAMILIES, "CDLNetVideo", *CSR_FAMILIES):
        raise NotImplementedError(f"the train CLI has no workload for {mtype!r}")
    if "PDFS" in loaders_args or mtype in CSR_FAMILIES:
        from cdlnet_tpu_torch.data.fastmri import (
            get_fastmri_fit_loaders,
            volume_to_batch_loaders,
        )

        loaders = get_fastmri_fit_loaders(**loaders_args)
        if mtype in IMAGE_FAMILIES:  # traincsr.py:163-165
            return volume_to_batch_loaders(loaders), "2d"
        return loaders, "mri"
    if mtype == "CDLNetVideo":
        from cdlnet_tpu_torch.data.video import get_video_fit_loaders

        return get_video_fit_loaders(**loaders_args), "3d"
    from cdlnet_tpu_torch.data.images import get_fit_loaders

    loaders_args.pop("depth", None)
    return get_fit_loaders(**loaders_args), "2d"


def main(args: dict, device=None):
    """Train from a reference-schema args dict: build the model (power-method
    init, or the checkpoint at paths.ckpt), its loaders and optimizer, and
    run fit() (fit_csr() for the CSR models), saving args.json beside each
    checkpoint. Returns (opt_state, history) as fit does."""
    from cdlnet_tpu_torch.train.checkpoint import save_args
    from cdlnet_tpu_torch.train.fit import fit, init_model
    from cdlnet_tpu_torch.train.fit_csr import fit_csr

    setup_debug()
    loaders, workload = make_loaders(args)
    model, opt, opt_state, epoch0, _ = init_model(args, device=device)
    fit_args = dict(args["train"].get("fit", {}))
    fit_args.pop("clip_grad", None)  # consumed by init_model's optimizer
    loss_type = fit_args.pop("loss", "mse")
    if fit_args.pop("combmse", False):  # train3d.py:65-66 flag spelling
        loss_type = "combmse"
    save_dir = args["paths"]["save"]
    if args["type"] in CSR_FAMILIES:
        return fit_csr(
            model, opt, opt_state, loaders,
            save_dir=save_dir,
            start_epoch=epoch0 + 1,
            sched=args["train"].get("sched"),
            mesh=args.get("dist", {}).get("mesh"),
            epoch_fun=lambda ep: save_args(args, save_dir),
            **fit_args,
        )
    return fit(
        model, opt, opt_state, loaders,
        save_dir=save_dir,
        start_epoch=epoch0 + 1,
        workload=workload,
        loss_type=loss_type,
        sched=args["train"].get("sched"),
        mesh=args.get("dist", {}).get("mesh"),
        epoch_fun=lambda ep: save_args(args, save_dir),
        **fit_args,
    )


def apply_backend(choice: str, args: dict) -> dict:
    """--backend into the model config: "auto" keeps a backend the config
    pins and otherwise picks the kernels ("pallas"), as on an accelerator;
    "pallas", "cuda" and "xla" override it. A family with no backend field
    (DnCNN, FFDNet) keeps its config (models.base.resolve_backend)."""
    model_args = args.get("model", {})
    if choice == "auto" and "backend" in model_args:
        return args
    backend = resolve_backend(args["type"], choice)
    if backend is None:
        return args
    return dict(args, model=dict(model_args, backend=backend))


def cli():
    """Console entry point: args.json schema + an optional --backend
    override (the JAX CLI's flag, with "cuda" as a name for the kernels)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="cdlnet-train-torch",
        description="Train from a reference-schema args.json on the PyTorch port.",
    )
    p.add_argument("arg_file", help="path/to/args.json (reference schema)")
    p.add_argument(
        "--backend", choices=["auto", "pallas", "cuda", "xla"], default=None,
        help='override model.backend from the config ("auto": the config\'s, '
        'else the hand-written kernels)',
    )
    a = p.parse_args()
    with open(a.arg_file) as f:
        args = json.load(f)
    if a.backend is not None:
        args = apply_backend(a.backend, args)
    pprint(args)
    main(args)


if __name__ == "__main__":
    cli()
