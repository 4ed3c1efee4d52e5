"""Device-resident training corpora and one-dispatch training epochs
(counterpart of cdlnet_tpu/train/device_data.py).

The host loop (train/fit.py) assembles every batch on the host (random
crops and flips of the loader) and issues every kernel of every step from
Python. Here the training corpus is staged on the model's device once, and
each step draws its batch there: per epoch a device permutation of the
items (the loader's shuffle, without replacement, drop_last), per step
the batch's crop offsets and flips drawn from a torch.Generator on the
device and assembled by index arithmetic, then the usual train step
(noise, forward, loss, backward, clipped Adam, projection). The same
protocol in distribution as the loader's; the random stream differs, as
the JAX package's device stream differs from its host loader's.

Images of mixed sizes are staged zero-padded to the corpus maximum with
their true sizes kept; crops never read padding. Portrait images are
staged transposed to landscape with a flag, and their crop is transposed
back: a crop of x^T transposed is a crop of x.

On the card make_epoch_runner captures one step into a CUDA graph and
replays it steps_per_epoch times an epoch: the host issues no kernel
through the kernels' Python wrappers during an epoch and synchronizes
once, to read the losses. Under a mesh, and on the CPU, the same steps
run eagerly.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cdlnet_tpu_torch.utils import default_device, trace_span

# eager steps on a side stream before a capture: they fill the caches a step
# reads (cuDNN plans, the kernels' row tables, the gather indices), and
# their effects on the state and the generator are undone
WARMUP_STEPS = 2


class DeviceImageCorpus:
    """A 2D image dataset staged on the device; crop batches drawn there."""

    def __init__(self, images, crop: int, batch: int, device=None):
        """images: list of (C, H, W) float32 arrays in [0, 1]."""
        self.crop = int(crop)
        self.batch = int(batch)
        self.device = default_device(device)
        C = images[0].shape[0]
        stage, sizes, transposed = [], [], []
        for im in images:
            _, H, W = im.shape
            t = H > W  # stage landscape
            if t:
                im = im.transpose(0, 2, 1)
                H, W = W, H
            if H < crop or W < crop:
                raise ValueError(f"image {im.shape} smaller than crop {crop}")
            stage.append(im)
            sizes.append((H, W))
            transposed.append(t)
        Hm = max(h for h, _ in sizes)
        Wm = max(w for _, w in sizes)
        padded = np.zeros((len(stage), C, Hm, Wm), np.float32)
        for i, im in enumerate(stage):
            padded[i, :, : im.shape[1], : im.shape[2]] = im
        self.n = len(stage)
        self.images = torch.from_numpy(padded).to(self.device)
        self.sizes = torch.tensor(sizes, dtype=torch.int64, device=self.device)
        self.transposed = torch.tensor(transposed, dtype=torch.bool, device=self.device)
        self.steps_per_epoch = self.n // self.batch  # drop_last
        self.staged_bytes = self.images.numel() * self.images.element_size()

    def epoch_perm(self, generator) -> torch.Tensor:
        return torch.randperm(self.n, generator=generator, device=self.device)

    def draw(self, idx, generator):
        """The batch's random draws for image indices idx (B,): (oh, ow) crop
        offsets, uniform within each staged image's true bounds, and (fh,
        fv) 0.5-probability horizontal and vertical flips."""
        B, c = idx.shape[0], self.crop
        hw = self.sizes[idx]
        u1 = torch.rand(B, generator=generator, device=self.device)
        u2 = torch.rand(B, generator=generator, device=self.device)
        oh = (u1 * (hw[:, 0] - c + 1)).to(torch.int64)
        ow = (u2 * (hw[:, 1] - c + 1)).to(torch.int64)
        fh = torch.rand(B, generator=generator, device=self.device) < 0.5
        fv = torch.rand(B, generator=generator, device=self.device) < 0.5
        return oh, ow, fh, fv

    def assemble(self, idx, oh, ow, fh, fv) -> torch.Tensor:
        """The (B, C, crop, crop) batch of the draws: the crop at (oh, ow) of
        each staged image, transposed back where it was staged transposed,
        then flipped along W where fh and along H where fv (the JAX
        package's order). One gather of computed indices: no host loop and
        no host read, so a CUDA graph can hold it."""
        B, c = idx.shape[0], self.crop
        n, C, Hm, Wm = self.images.shape
        ar = torch.arange(c, device=self.device)
        i = torch.where(fv.view(B, 1, 1), c - 1 - ar.view(1, c, 1), ar.view(1, c, 1))
        j = torch.where(fh.view(B, 1, 1), c - 1 - ar.view(1, 1, c), ar.view(1, 1, c))
        tr = self.transposed[idx].view(B, 1, 1)
        rows = torch.where(tr, j, i) + oh.view(B, 1, 1)  # (B, c, c)
        cols = torch.where(tr, i, j) + ow.view(B, 1, 1)
        chan = torch.arange(C, device=self.device).view(1, C, 1, 1)
        lin = ((idx.view(B, 1, 1, 1) * C + chan) * Hm + rows[:, None]) * Wm + cols[:, None]
        return torch.take(self.images, lin)

    def sample(self, idx, generator) -> torch.Tensor:
        return self.assemble(idx, *self.draw(idx, generator))


class DeviceClipCorpus:
    """A video clip dataset staged on the device; clip batches drawn there.

    VideoClipDataset's train protocol (data/video.py) with device draws,
    per sample:
      - with probability `aug_prob`: a random-walk crop over a depth window
        that wraps around the video, its offsets drifting up to max_shift
        px a frame;
      - else: a consecutive window, reversed with probability 0.5, with one
        shared crop with probability `crop_ratio`, otherwise the whole frame
        resized to the crop size (bilinear with antialiasing, as
        jax.image.resize; the host loader resizes with PIL).
    Videos are staged as one (V, C, F, H, W) tensor, frame counts padded to
    the longest and the true ones kept; frame sizes must match.
    """

    def __init__(self, videos, depth: int, crop: tuple, batch: int,
                 crop_ratio: float, aug_prob: float, max_shift: int, device=None):
        """videos: list of (C, F_i, H, W) float32 arrays in [0, 1]."""
        self.depth = int(depth)
        self.crop = tuple(crop)  # (cw, ch): VideoClipDataset's image_size
        self.batch = int(batch)
        self.crop_ratio = float(crop_ratio)
        self.aug_prob = float(aug_prob)
        self.max_shift = int(max_shift)
        self.device = default_device(device)
        C, _, H, W = videos[0].shape
        if any(v.shape[0] != C or v.shape[2:] != (H, W) for v in videos):
            raise ValueError("videos must share channel count and frame size")
        cw, ch = self.crop
        if cw > W or ch > H:
            raise ValueError(f"crop {self.crop} larger than frames {(W, H)}")
        if any(v.shape[1] < self.depth for v in videos):
            raise ValueError(f"videos shorter than depth {self.depth}")
        Fm = max(v.shape[1] for v in videos)
        self.videos = torch.zeros((len(videos), C, Fm, H, W), dtype=torch.float32,
                                  device=self.device)
        for i, v in enumerate(videos):
            self.videos[i, :, : v.shape[1]] = torch.from_numpy(np.ascontiguousarray(v))
        self.n = len(videos)
        self.nframes = torch.tensor([v.shape[1] for v in videos], dtype=torch.int64,
                                    device=self.device)
        self.steps_per_epoch = self.n // self.batch
        self.frame_hw = (H, W)
        self.staged_bytes = self.videos.numel() * self.videos.element_size()

    def epoch_perm(self, generator) -> torch.Tensor:
        return torch.randperm(self.n, generator=generator, device=self.device)

    def draw(self, idx, generator) -> tuple:
        """The batch's random draws for video indices idx (B,), each (B,)
        but steps: (walk, start_w, x0, y0, steps (B, 2, depth), start_c, rev,
        do_crop, cx, cy) — the random-walk choice, its window start, first
        offsets and per-frame shifts, the consecutive window's start, its
        reversal, the shared-crop choice and that crop's offsets."""
        B, D = idx.shape[0], self.depth
        cw, ch = self.crop
        H, W = self.frame_hw
        n = self.nframes[idx]
        kw = dict(generator=generator, device=self.device)
        walk = torch.rand(B, **kw) < self.aug_prob
        start_w = torch.minimum((torch.rand(B, **kw) * n).to(torch.int64), n - 1)
        x0 = torch.randint(0, W - cw + 1, (B,), **kw)
        y0 = torch.randint(0, H - ch + 1, (B,), **kw)
        steps = torch.randint(-self.max_shift, self.max_shift + 1, (B, 2, D), **kw)
        start_c = torch.minimum((torch.rand(B, **kw) * (n - D + 1)).to(torch.int64), n - D)
        rev = torch.rand(B, **kw) < 0.5
        do_crop = torch.rand(B, **kw) < self.crop_ratio
        cx = torch.randint(0, W - cw + 1, (B,), **kw)
        cy = torch.randint(0, H - ch + 1, (B,), **kw)
        return walk, start_w, x0, y0, steps, start_c, rev, do_crop, cx, cy

    def assemble(self, idx, walk, start_w, x0, y0, steps, start_c, rev, do_crop,
                 cx, cy) -> torch.Tensor:
        """The (B, C, depth, ch, cw) batch of the draws (draw()): each
        sample's frames and offsets by the JAX package's rules, the crops
        gathered by computed indices, and where the frames exceed the crop
        size the whole frames resized too, a select picking per sample."""
        B, D = idx.shape[0], self.depth
        cw, ch = self.crop
        H, W = self.frame_hw
        V, C, Fm = self.videos.shape[:3]
        dev = self.device
        t = torch.arange(D, device=dev)
        n = self.nframes[idx].view(B, 1)
        xs = (x0.view(B, 1) + torch.cumsum(steps[:, 0], -1)).clamp(0, W - cw)
        ys = (y0.view(B, 1) + torch.cumsum(steps[:, 1], -1)).clamp(0, H - ch)
        walk_, crop_ = walk.view(B, 1), do_crop.view(B, 1)
        tw = torch.remainder(start_w.view(B, 1) + t, n)  # walk frame (wraps)
        tc = start_c.view(B, 1) + torch.where(rev.view(B, 1), D - 1 - t, t)
        fidx = torch.where(walk_, tw, tc)  # (B, D)
        zero = torch.zeros_like(cx).view(B, 1)
        ox = torch.where(walk_, xs, torch.where(crop_, cx.view(B, 1), zero))
        oy = torch.where(walk_, ys, torch.where(crop_, cy.view(B, 1), zero))
        v5 = idx.view(B, 1, 1, 1, 1)
        c5 = torch.arange(C, device=dev).view(1, C, 1, 1, 1)
        f5 = fidx.view(B, 1, D, 1, 1)
        r5 = oy.view(B, 1, D, 1, 1) + torch.arange(ch, device=dev).view(1, 1, 1, ch, 1)
        q5 = ox.view(B, 1, D, 1, 1) + torch.arange(cw, device=dev).view(1, 1, 1, 1, cw)
        lin = (((v5 * C + c5) * Fm + f5) * H + r5) * W + q5
        crops = torch.take(self.videos, lin)  # (B, C, D, ch, cw)
        if (H, W) == (ch, cw):
            return crops
        frames = self.videos.permute(0, 2, 1, 3, 4)[idx.view(B, 1), fidx]  # (B, D, C, H, W)
        resized = F.interpolate(frames.reshape(B * D, C, H, W), size=(ch, cw),
                                mode="bilinear", align_corners=False, antialias=True)
        resized = resized.view(B, D, C, ch, cw).permute(0, 2, 1, 3, 4)
        keep = (walk | do_crop).view(B, 1, 1, 1, 1)
        return torch.where(keep, crops, resized)

    def sample(self, idx, generator) -> torch.Tensor:
        return self.assemble(idx, *self.draw(idx, generator))


def corpus_from_video_loader(loader, device=None):
    """A DeviceClipCorpus of a fit train loader when it qualifies (clip
    training on a VideoClipDataset, not test, with shuffle and drop_last, at
    least one batch of videos, every video at least `depth` frames, uniform
    frame sizes holding the crop, the staged frames under
    $CDLNET_CORPUS_MAX_MB, 2048 by default). None when it does not."""
    from cdlnet_tpu_torch.data.images import _load_image
    from cdlnet_tpu_torch.data.loader import DataLoader
    from cdlnet_tpu_torch.data.video import VideoClipDataset

    if not isinstance(loader, DataLoader):
        return None
    ds = loader.dataset
    if not isinstance(ds, VideoClipDataset) or ds.test:
        return None
    if not loader.shuffle or not loader.drop_last:
        return None
    if len(ds) < loader.batch_size:
        return None
    # probe sizes before loading everything
    cap_mb = float(os.environ.get("CDLNET_CORPUS_MAX_MB", "2048"))
    files = [ds._frame_files(v) for v in ds.video_dirs]
    if any(len(f) < ds.depth for f in files):
        return None
    first = _load_image(files[0][0], ds.load_color)
    C, H, W = first.shape
    total = sum(len(f) for f in files) * C * H * W * 4
    if total > cap_mb * 1024 * 1024:
        return None
    videos = []
    for i, fl in enumerate(files):
        frames = [first if (i, j) == (0, 0) else _load_image(f, ds.load_color)
                  for j, f in enumerate(fl)]
        if any(fr.shape != (C, H, W) for fr in frames):
            return None
        videos.append(np.stack(frames, axis=1))
    cw, ch = ds.image_size
    if cw > W or ch > H:
        return None
    try:
        return DeviceClipCorpus(videos, ds.depth, ds.image_size, loader.batch_size,
                                ds.crop_ratio, ds.aug_prob, ds.max_shift, device=device)
    except ValueError:
        return None


def corpus_from_loader(loader, workload: str, device=None):
    """A device corpus of a fit train loader when the workload qualifies:
    workload "3d" through corpus_from_video_loader; "2d" for an ImageDataset
    with crop_size and augment on a DataLoader with shuffle and drop_last
    and at least one batch of images. None when it does not (the JAX
    package's rules)."""
    from cdlnet_tpu_torch.data.images import ImageDataset
    from cdlnet_tpu_torch.data.loader import DataLoader

    if workload == "3d":
        return corpus_from_video_loader(loader, device)
    if workload != "2d" or not isinstance(loader, DataLoader):
        return None
    ds = loader.dataset
    if not isinstance(ds, ImageDataset):
        return None
    # the runner draws a fresh permutation an epoch, so an unshuffled loader
    # (a fixed epoch order) keeps the host loop
    if ds.crop_size is None or not ds.augment or not loader.drop_last \
            or not loader.shuffle:
        return None
    if len(ds) < loader.batch_size:
        return None
    try:
        return DeviceImageCorpus(ds.images, ds.crop_size, loader.batch_size, device=device)
    except ValueError:
        return None


class EpochRunner:
    """One training epoch over a device corpus: run(opt_state, generator)
    -> the epoch's losses, a (steps_per_epoch,) tensor on the device. The
    parameters, BatchNorm statistics and opt_state change in place.

    Every step takes the next batch of the epoch's permutation, assembles
    it on the device and calls train_step(opt_state, batch, generator); the
    step index and the losses live in device tensors, so the step reads no
    host number. graph=True captures that step into a CUDA graph (after
    WARMUP_STEPS eager steps on a side stream, whose effects on the
    parameters, statistics, opt_state and generator are undone) and
    replays it; a capture that fails raises. The graph reads the tensors
    it captured: they must change in place only (set_lr, load_ckpt and
    load_state_dict do), and a run that finds one rebound captures anew.
    graph=False runs the same steps eagerly. Draws come from `generator`,
    which a graph registers, so replays and the eager steps draw the same
    numbers from the same state."""

    warmup = WARMUP_STEPS

    def __init__(self, corpus, train_step, model, graph: bool):
        self.corpus, self.train_step, self.model = corpus, train_step, model
        self.graphed = graph
        self.steps = corpus.steps_per_epoch
        dev = corpus.device
        self._perm = torch.zeros((self.steps, corpus.batch), dtype=torch.int64, device=dev)
        self._at = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.losses = torch.zeros((self.steps,), dtype=torch.float32, device=dev)
        self.graph = None
        self._captured = None
        self.capture_ms = None

    def _step(self, opt_state, generator):
        idx = self._perm.index_select(0, self._at).view(-1)
        batch = self.corpus.sample(idx, generator)
        loss = self.train_step(opt_state, batch, generator)
        self.losses.index_copy_(0, self._at, loss.detach().reshape(1).to(self.losses.dtype))
        self._at.add_(1)

    def _live(self, opt_state) -> list:
        """The tensors a step reads and writes in place."""
        leaves = [opt_state["count"], *opt_state["hyperparams_dev"].values(),
                  *opt_state["mu"].values(), *opt_state["nu"].values()]
        return [*self.model.parameters(), *self.model.buffers(), *leaves]

    def _key(self, opt_state, generator) -> tuple:
        return (id(generator), *(t.data_ptr() for t in self._live(opt_state)))

    def capture(self, opt_state, generator) -> None:
        """Warm up, undo the warm-up, and capture one step into self.graph."""
        import time

        from cdlnet_tpu_torch.train.optim import place_scalars

        dev = self.corpus.device
        place_scalars(opt_state, dev)
        live = self._live(opt_state)
        with torch.no_grad():
            saved = [t.detach().clone() for t in live]
        gen_state = generator.get_state()
        t0 = time.perf_counter()
        self._perm.copy_(torch.arange(self._perm.numel(), device=dev).view_as(self._perm)
                         % self.corpus.n)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                self._at.zero_()
                self._step(opt_state, generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        generator.set_state(gen_state)
        self._at.zero_()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph):
            self._step(opt_state, generator)
        torch.cuda.synchronize(dev)
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.graph = graph
        self._captured = self._key(opt_state, generator)

    def begin(self, generator) -> None:
        """Draw the epoch's permutation and rewind to its first step."""
        with trace_span("train_epoch_begin"):
            perm = self.corpus.epoch_perm(generator)
            self._perm.copy_(perm[: self._perm.numel()].view_as(self._perm))
            self._at.zero_()

    def advance(self, opt_state, generator) -> None:
        """One step: the graph's replay, or the step run eagerly."""
        with trace_span("train_epoch_step"):
            if self.graphed:
                self.graph.replay()
            else:
                self._step(opt_state, generator)

    def __call__(self, opt_state, generator) -> torch.Tensor:
        """The epoch, in a train_epoch_scan span (begin, each advance and
        the losses' copy in spans of their own); a capture it needs first
        is set-up, outside the span."""
        if self.graphed and self._captured != self._key(opt_state, generator):
            self.capture(opt_state, generator)
        with trace_span("train_epoch_scan"):
            self.begin(generator)
            for _ in range(self.steps):
                self.advance(opt_state, generator)
            with trace_span("train_epoch_losses"):
                return self.losses.clone()


def make_epoch_runner(corpus, train_step, model, *, graph=None) -> EpochRunner:
    """The epoch runner of `corpus` for train_step (train.fit.make_train_step's)
    on `model`: run(opt_state, generator) -> losses (steps_per_epoch,).
    graph None captures a CUDA graph on the card and runs eagerly on the
    CPU; True on the CPU raises."""
    on_card = corpus.device.type == "cuda"
    graph = on_card if graph is None else bool(graph)
    if graph and not on_card:
        raise ValueError("graph=True needs a corpus on a CUDA device")
    return EpochRunner(corpus, train_step, model, graph)
