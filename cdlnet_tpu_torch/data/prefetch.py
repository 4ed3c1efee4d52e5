"""Host -> device prefetch (counterpart of cdlnet_tpu/data/prefetch.py):
while the device computes on batch i, batches i+1 .. i+size are already
being copied.

On a CUDA device each host batch is staged in pinned host memory and copied
with non_blocking=True on a side stream, so the copy overlaps the step the
consumer's stream is running. Three rules keep that correct:
  - the consumer's stream waits on the copy's event before the tensor is
    yielded, so the step never reads a batch still in flight;
  - the device tensor is allocated on the side stream and freed on the
    consumer's, so it is record_stream'ed there: the caching allocator then
    does not hand its block to the next copy while the step still reads it;
  - a pinned buffer is written again only after its last copy's event has
    completed.
On any other device the batches are torch.as_tensor'ed there, one by one.
"""

from __future__ import annotations

import collections

import torch

from cdlnet_tpu_torch.utils import default_device


class _PinnedBuffers:
    """Pinned host buffers reused by shape, each with the event of the last
    copy out of it."""

    def __init__(self):
        self._free = collections.defaultdict(list)  # shape -> [(buffer, event)]

    def take(self, shape) -> torch.Tensor:
        free = self._free[tuple(shape)]
        if free:
            buf, event = free.pop(0)
            event.synchronize()  # its last copy must be done before it is overwritten
            return buf
        return torch.empty(shape, dtype=torch.float32, pin_memory=True)

    def give(self, buf: torch.Tensor, event: torch.cuda.Event) -> None:
        self._free[tuple(buf.shape)].append((buf, event))


def device_prefetch(iterator, size: int = 2, device=None):
    """Wrap an iterator of host batches (numpy arrays or tensors); yields
    float32 tensors on `device` (the card when None), `size` batches ahead.
    Stopping early (close(), or dropping the generator) closes the wrapped
    iterator, so a DataLoader cancels the batches its workers still have
    queued."""
    device = default_device(device)
    it = iter(iterator)
    try:
        if device.type != "cuda":
            for batch in it:
                yield torch.as_tensor(batch, dtype=torch.float32, device=device)
            return
        yield from _cuda_prefetch(it, size, device)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def _cuda_prefetch(it, size, device):
    side = torch.cuda.Stream(device)
    pinned = _PinnedBuffers()
    queue = collections.deque()  # (device tensor, copy event, pinned buffer)

    def put(batch):
        host = torch.as_tensor(batch, dtype=torch.float32)
        if host.device.type == "cuda":  # already on a card: a plain device copy
            queue.append((host.to(device), None, None))
            return
        buf = pinned.take(host.shape)
        buf.copy_(host)
        with torch.cuda.stream(side):
            dev = buf.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        queue.append((dev, event, buf))

    for _ in range(size):
        batch = next(it, None)
        if batch is None:
            break
        put(batch)
    while queue:
        dev, event, buf = queue.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            dev.record_stream(consumer)
            pinned.give(buf, event)
        yield dev
        batch = next(it, None)
        if batch is not None:
            put(batch)
