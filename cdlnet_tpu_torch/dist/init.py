"""Multi-process initialization (counterpart of cdlnet_tpu/dist/init.py).

Each mesh rank is one process, as under torchrun: one process per card
under NCCL, or processes on the CPU (or sharing a card) under gloo. The
tiers of the JAX package map onto torch.distributed as
  - one process: no init needed (initialize_distributed returns False);
  - many processes on one host or many: a default process group over a
    TCP rendezvous, from arguments or the environment;
  - many nodes: make_hybrid_mesh puts an outer "replica" dim over the
    nodes, so that only data parallelism crosses the slow links.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _int_env(*names):
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def _init_method(coordinator_address):
    """The rendezvous: tcp:// at the coordinator address (the argument,
    else COORDINATOR_ADDRESS), else env:// when torchrun's MASTER_ADDR and
    MASTER_PORT are set (under torchrun the ranks join the store its agent
    serves there), else None."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is not None:
        return f"tcp://{addr}"
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        return "env://"
    return None


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None, *,
                           backend=None, device=None):
    """Idempotent init of the default process group. Returns True when a
    group was (or already is) initialized, False for a single process with
    no configuration.

    coordinator_address ("host:port"), num_processes and process_id fall
    back to COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, then to
    torchrun's MASTER_ADDR + MASTER_PORT / WORLD_SIZE / RANK.
    local_device_ids (else LOCAL_RANK, else the process id modulo the
    cards) picks this process's card. The backend follows `device` (the
    card when one is present, else the CPU): NCCL for cuda, gloo for cpu;
    pass backend="gloo" to run gloo on a card (several processes sharing
    one card). An NCCL init that fails raises: gloo is never taken in its
    place."""
    if dist.is_initialized():
        return True
    init_method = _init_method(coordinator_address)
    if num_processes is None:
        num_processes = _int_env("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("PROCESS_ID", "RANK")
    if init_method is None and num_processes is None:
        return False  # single process
    if init_method is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number of "
            f"processes and this process's id; got {init_method!r}, "
            f"{num_processes!r}, {process_id!r}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if local_device_ids is not None:
            local = list(local_device_ids)[0]
        else:
            local = _int_env("LOCAL_RANK")
            if local is None:
                local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def shutdown_distributed():
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def node_count(hosts) -> int:
    """The number of nodes from each rank's host name, in rank order. The
    ranks of a node must be consecutive and every node must hold as many
    (torchrun's layout), so that the node is the mesh's outer dim."""
    nodes = [h for i, h in enumerate(hosts) if i == 0 or h != hosts[i - 1]]
    per_node = len(hosts) // len(nodes)
    if len(set(nodes)) != len(nodes) or per_node * len(nodes) != len(hosts) or any(
            hosts[i] != hosts[i - i % per_node] for i in range(len(hosts))):
        raise ValueError(f"the ranks' hosts {hosts} are not consecutive blocks of one size")
    return len(nodes)


def make_hybrid_mesh(ici_spec: dict, dcn_axis: str = "replica"):
    """A mesh over several nodes: `dcn_axis` indexes the nodes (data
    parallelism over the slow inter-node links), ici_spec's dims partition
    the ranks within a node, as JAX's make_hybrid_mesh does over slices.
    The nodes are told apart by host name (node_count); one node gives a
    replica size of 1.

    Example: 2 nodes of 4 ranks, ici_spec={"data": 2, "depth": 2} ->
    a mesh of shape {"replica": 2, "data": 2, "depth": 2}."""
    import math
    import socket

    from cdlnet_tpu_torch.dist.mesh import make_mesh, world_size

    hosts = [socket.gethostname()]
    if dist.is_initialized():
        hosts = [None] * world_size()
        dist.all_gather_object(hosts, socket.gethostname())
    n_nodes = node_count(hosts)
    per_node = world_size() // n_nodes
    sizes = dict(ici_spec)
    if list(sizes.values()).count(-1) == 1:
        known = math.prod(v for v in sizes.values() if v != -1)
        sizes[next(k for k, v in sizes.items() if v == -1)] = per_node // known
    return make_mesh({dcn_axis: n_nodes, **sizes})
