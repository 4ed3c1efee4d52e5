"""The system under test, as a user drives it: cdlnet_tpu_torch's models,
Denoiser, training step, device corpora and epoch runner. Everything the
benchmark takes from the program goes through here."""

from __future__ import annotations

import torch


def build(config: dict, weights: dict, device):
    """The configuration's model on `device`, holding the benchmark's
    weights."""
    from cdlnet_tpu_torch.models.base import build_model

    model = build_model(config["type"], dict(config["model"])).to(device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def denoiser(model, bucket: int):
    """The Denoiser of the model, blind by its MAD estimate."""
    from cdlnet_tpu_torch.serve import Denoiser

    return Denoiser(model, bucket=bucket, blind="MAD")


def launches() -> int:
    """Kernel launches so far, summed over the wrappers' names (2D and 3D)."""
    from cdlnet_tpu_torch.kernels.lista3d import launches as counter

    return sum(counter.values())


def trainer(model, train: dict, workload: str):
    """(opt_state, train_step) of the configuration's optimizer and noise."""
    from cdlnet_tpu_torch.train.fit import make_train_step
    from cdlnet_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer(train["lr"], clip_grad=train["clip_grad"])
    opt_state = opt.init(dict(model.named_parameters()))
    step, _ = make_train_step(model, opt, workload=workload,
                              noise_std=tuple(train["noise_std"]))
    return opt_state, step


def image_corpus(images, crop: int, batch: int, device):
    from cdlnet_tpu_torch.train.device_data import DeviceImageCorpus

    return DeviceImageCorpus(images, crop, batch, device=device)


def clip_corpus(videos, train: dict, device):
    from cdlnet_tpu_torch.train.device_data import DeviceClipCorpus

    crop = (train["crop"], train["crop"])
    return DeviceClipCorpus(videos, train["depth"], crop, train["batch"], train["crop_ratio"],
                            train["aug_prob"], train["max_shift"], device=device)


def epoch_runner(corpus, step, model):
    from cdlnet_tpu_torch.train.device_data import make_epoch_runner

    return make_epoch_runner(corpus, step, model)


def adam_c1() -> float:
    """1 - b1 as the optimizer's float32 arithmetic takes it: the first
    moment after one step is c1 times the clipped gradient."""
    return float(1 - torch.tensor(0.9, dtype=torch.float32))
