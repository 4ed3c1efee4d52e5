"""Small shared helpers (counterpart of the trainer's half of
cdlnet_tpu/utils.py)."""

from __future__ import annotations

import json
import os
import time

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    card. Without one it raises: the CPU is taken only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: cdlnet_tpu_torch runs on the card by default; "
            'pass device="cpu" to run on the CPU (the kernels\' plain versions)'
        )
    return torch.device("cuda")


def append_metric(save_dir: str, **kv):
    """Append one JSON object to {save_dir}/metrics.jsonl — the structured
    mirror of the txt logs ({phase}.txt, backtrack.txt), which stay
    byte-compatible with the reference's."""
    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"ts": round(time.time(), 3), **kv}) + "\n")
