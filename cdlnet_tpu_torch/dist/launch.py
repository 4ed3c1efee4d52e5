"""The multi-process launcher of the train CLI (counterpart of
examples/launch_pod.sh): every rank runs cli.train.main on the same
args.json, after initialize_distributed(). Put "dist": {"mesh": {"data":
-1}} in args.json so that every rank takes its share of each batch (the
batch size must divide by the number of ranks); each rank writes the save
directory its args.json names.

Either export the rendezvous and start one process a rank:

    COORDINATOR_ADDRESS=host0:8476 NUM_PROCESSES=2 PROCESS_ID=0 \\
        python -m cdlnet_tpu_torch.dist.launch args.json

or let torchrun set MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK:

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m cdlnet_tpu_torch.dist.launch args.json

Each rank runs on its card (NCCL) unless --device cpu is given (gloo);
--backend gloo lets several ranks share one card.
A "{rank}" in paths.save becomes the rank, so that ranks started from one
args.json (torchrun) keep their checkpoints apart.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m cdlnet_tpu_torch.dist.launch",
                                description="Run the train CLI on every rank.")
    p.add_argument("arg_file", help="path/to/args.json (reference schema)")
    p.add_argument("--device", default=None,
                   help='"cpu" to train on the CPU over gloo (default: the card, NCCL)')
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: NCCL on the card, gloo "
                   "on the CPU; gloo lets several ranks share one card)")
    a = p.parse_args(argv)
    from cdlnet_tpu_torch.dist.init import initialize_distributed, shutdown_distributed

    initialize_distributed(device=a.device, backend=a.backend)
    try:
        from cdlnet_tpu_torch.cli.train import main as train_main

        with open(a.arg_file) as f:
            args = json.load(f)
        save = (args.get("paths") or {}).get("save")
        if save and "{rank}" in save:
            import torch.distributed as dist

            rank = dist.get_rank() if dist.is_initialized() else 0
            args["paths"]["save"] = save.replace("{rank}", str(rank))
        return train_main(args, device=a.device)
    finally:
        shutdown_distributed()


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_local(argv, n: int, env=None, timeout=600):
    """Run `argv` as n processes of this host, ranks 0..n-1, with
    COORDINATOR_ADDRESS (a free localhost port), NUM_PROCESSES and
    PROCESS_ID in their environment (initialize_distributed reads them).
    Waits for all of them; a rank still running at `timeout` seconds, or
    once another rank has failed, is killed. Returns (returncodes,
    outputs), each rank's stdout and stderr together."""
    import tempfile
    import time

    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(n):
            penv = dict(os.environ if env is None else env)
            penv.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(n),
                        PROCESS_ID=str(rank))
            logs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen(argv, stdout=logs[-1], stderr=subprocess.STDOUT,
                                          text=True, env=penv))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return [p.returncode for p in procs], outs


if __name__ == "__main__":
    main()
