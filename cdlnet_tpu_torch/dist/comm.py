"""The collectives of the mesh, on torch.distributed ProcessGroups.

Every rank runs the same program and holds the global batch; a sharded
function takes its rows or frames, computes on them and gathers the
result, so every rank gets the whole output. The differentiable pieces
keep the unsharded function's gradients on every rank (JAX's shard_map
transpose):
  shard(x)       slice of a replicated tensor; backward: all-gather
  unshard(x)     all-gather of the slices; backward: this rank's slice
                 (every rank computes the same loss from the output)
  replicate(ps)  parameters used on every rank; backward: all-reduce
                 sum of their gradients (the data-parallel gradient
                 all-reduce, and the depth ranks' partial weight
                 gradients)
  reduce(x)      all-reduce sum of partial results (subband synthesis,
                 BatchNorm moments); backward: identity, or the sum again
                 where each rank's cotangent is only its own share
  window(x)      a block extended by frames of its neighbours (halo
                 exchange, point to point); backward: the halo
                 cotangents go back to their owners and add into their
                 frames
A group of None (a mesh dim of size 1 without a process group) makes each
of them an identity. A gloo group and CUDA tensors: the collectives stage
through host memory (gloo moves host buffers), NCCL keeps them on the
card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on `t` in `group` goes through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_index(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place all-reduce sum of a contiguous tensor over the group."""
    if group is None:
        return t
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_reduce_many_(tensors, group):
    """In place all-reduce sum of several float tensors as one flat
    buffer: one collective call."""
    tensors = [t for t in tensors if t is not None]
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's equal-shaped blocks concatenated along dim, in rank
    order."""
    if group is None:
        return t
    src = t.contiguous()
    if _staged(src, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, group, src_index: int = 0) -> torch.Tensor:
    """In place: the group's rank src_index's values on every rank."""
    if group is None:
        return t
    src = dist.get_global_rank(group, src_index)
    if _staged(t, group):
        h = t.cpu()
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def p2p(sends, recvs, group, like: torch.Tensor):
    """Point-to-point exchange within a group, all in one batch.

    sends: [(peer index, tensor)]; recvs: [(peer index, shape)], dtype and
    device of `like`. Returns the received tensors, in order."""
    if not sends and not recvs:
        return []
    ranks = dist.get_process_group_ranks(group)
    host = _staged(like, group)
    ops, bufs = [], []
    for q, t in sends:
        buf = t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf, ranks[q], group))
    for q, shape in recvs:
        buf = torch.empty(shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[q], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(like.device) for b in bufs]


# --- halo windows --------------------------------------------------------

def window_plan(n: int, L: int, windows, me: int):
    """The exchange of rank `me` whose kept block is global frames
    [me*L, (me+1)*L) and whose window is windows[me] = (a, b); each
    rank's window is known to all. Returns (own, sends, recvs): own =
    (window offset, block offset, length) of the block's frames in the
    window or None; sends = [(q, block offset, length)] of frames rank q's
    window takes from this block; recvs = [(q, window offset, length)] of
    frames this window takes from rank q's block. Window frames outside
    every block (past the global edges) are zeros."""
    a, b = windows[me]
    sends, recvs = [], []
    for q in range(n):
        if q == me:
            continue
        lo, hi = max(me * L, windows[q][0]), min((me + 1) * L, windows[q][1])
        if lo < hi:
            sends.append((q, lo - me * L, hi - lo))
        lo, hi = max(q * L, a), min((q + 1) * L, b)
        if lo < hi:
            recvs.append((q, lo - a, hi - lo))
    lo, hi = max(me * L, a), min((me + 1) * L, b)
    own = (lo - a, lo - me * L, hi - lo) if lo < hi else None
    return own, sends, recvs


def _shape(x, dim, length):
    shape = list(x.shape)
    shape[dim] = length
    return shape


def fill_window_(win, block, plan, group, dim):
    """Write the window's frames from `block` (this rank's kept frames),
    from the neighbours' blocks, and zeros past the global edges, in
    place. `block` may be a view of win's own frames."""
    own, sends, recvs = plan
    got = p2p([(q, block.narrow(dim, o, n)) for q, o, n in sends],
              [(q, _shape(win, dim, n)) for q, o, n in recvs], group, block)
    covered = torch.zeros(win.shape[dim], dtype=torch.bool)
    if own is not None:
        wo, bo, n = own
        if block.data_ptr() != win.narrow(dim, wo, n).data_ptr():
            win.narrow(dim, wo, n).copy_(block.narrow(dim, bo, n))
        covered[wo:wo + n] = True
    for (q, wo, n), part in zip(recvs, got):
        win.narrow(dim, wo, n).copy_(part)
        covered[wo:wo + n] = True
    for i in (~covered).nonzero().flatten().tolist():
        win.narrow(dim, i, 1).zero_()
    return win


def window(block, plan, group, dim, length):
    """A new window of `length` frames along dim around this rank's kept
    `block` (fill_window_)."""
    win = block.new_empty(_shape(block, dim, length))
    return fill_window_(win, block, plan, group, dim)


def window_adjoint(gwin, plan, group, dim, L):
    """The adjoint of window(): the cotangent of this rank's block from
    the cotangents of every window that took its frames."""
    own, sends, recvs = plan
    got = p2p([(q, gwin.narrow(dim, wo, n)) for q, wo, n in recvs],
              [(q, _shape(gwin, dim, n)) for q, bo, n in sends], group, gwin)
    g = gwin.new_zeros(_shape(gwin, dim, L))
    if own is not None:
        wo, bo, n = own
        g.narrow(dim, bo, n).add_(gwin.narrow(dim, wo, n))
    for (q, bo, n), part in zip(sends, got):
        g.narrow(dim, bo, n).add_(part)
    return g


# --- differentiable collectives ------------------------------------------

class _Replicate(Function):
    @staticmethod
    def forward(ctx, groups, *ts):
        ctx.groups = groups
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        grads = [g.contiguous().clone() for g in grads]
        for group in ctx.groups:
            all_reduce_many_(grads, group)
        return (None, *grads)


def replicate(params: dict, groups) -> dict:
    """params (name -> tensor) as used on every rank of each group: the
    identity, whose backward sums the gradients over the groups (one flat
    all-reduce a group)."""
    groups = tuple(g for g in groups if g is not None)
    if not groups or not torch.is_grad_enabled():
        return dict(params)
    names = list(params)
    return dict(zip(names, _Replicate.apply(groups, *(params[n] for n in names))))


class _Reduce(Function):
    @staticmethod
    def forward(ctx, t, group, bwd_sum):
        ctx.group, ctx.bwd_sum = group, bwd_sum
        return all_reduce_(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return (all_reduce_(g.clone(), ctx.group) if ctx.bwd_sum else g), None, None


def reduce(t, group, bwd_sum=False):
    """All-reduce sum over the group. Its backward passes the cotangent on
    (bwd_sum False: every rank's cotangent of the sum is already the
    whole one) or sums it over the group (bwd_sum True: each rank's
    cotangent is the share of its own rows)."""
    return t if group is None else _Reduce.apply(t, group, bwd_sum)


class _Shard(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group_size(group)
        return x.narrow(dim, group_index(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def shard(x, group, dim):
    """This rank's block of a tensor that every rank holds whole, along
    dim (divisible by the group size)."""
    return x if group is None else _Shard.apply(x, group, dim)


class _Unshard(Function):
    @staticmethod
    def forward(ctx, x, group, dim, bwd_sum):
        ctx.group, ctx.dim, ctx.bwd_sum, ctx.n = group, dim, bwd_sum, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.bwd_sum:
            g = all_reduce_(g.clone(), ctx.group)
        return g.narrow(ctx.dim, group_index(ctx.group) * ctx.n, ctx.n).contiguous(), \
            None, None, None


def unshard(x, group, dim, bwd_sum=False):
    """The group's blocks gathered along dim, on every rank. Backward: this
    rank's block of the cotangent (bwd_sum False: every rank computes the
    same loss from the whole tensor) or of its sum over the group
    (bwd_sum True: each rank uses the whole tensor its own way)."""
    return x if group is None else _Unshard.apply(x, group, dim, bwd_sum)


class _Window(Function):
    @staticmethod
    def forward(ctx, x, plan, group, dim, length):
        ctx.plan, ctx.group, ctx.dim, ctx.L = plan, group, dim, x.shape[dim]
        return window(x.contiguous(), plan, group, dim, length)

    @staticmethod
    def backward(ctx, g):
        return window_adjoint(g.contiguous(), ctx.plan, ctx.group, ctx.dim, ctx.L), \
            None, None, None, None


def window_diff(x, plan, group, dim, length):
    """window() with its adjoint as the backward."""
    return _Window.apply(x, plan, group, dim, length)
