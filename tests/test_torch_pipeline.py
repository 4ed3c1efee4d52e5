"""The port's input pipeline on the CPU: the loader's thread-pool workers
(data/loader.py) against the JAX package's loaders, device_prefetch
(data/prefetch.py) on a CPU device, fit and fit_csr fed through it, and
the train CLI passing num_workers on."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from cdlnet_tpu.data.fastmri import get_fastmri_data_loader as jax_get_fastmri_data_loader
from cdlnet_tpu.data.images import get_data_loader as jax_get_data_loader
from cdlnet_tpu.data.images import get_fit_loaders as jax_get_fit_loaders
from cdlnet_tpu.data.video import get_video_loader as jax_get_video_loader
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.data.fastmri import get_fastmri_data_loader
from cdlnet_tpu_torch.data.images import get_data_loader, get_fit_loaders
from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng
from cdlnet_tpu_torch.data.prefetch import device_prefetch
from cdlnet_tpu_torch.data.synthetic import (
    gen_synthetic_image_dirs,
    gen_synthetic_mri_dirs,
    gen_synthetic_video_dirs,
)
from cdlnet_tpu_torch.data.video import get_video_loader
from cdlnet_tpu_torch.models import CDLNetCSR, CDLNetVideo
from cdlnet_tpu_torch.train.fit import fit
from cdlnet_tpu_torch.train.fit_csr import fit_csr
from cdlnet_tpu_torch.train.optim import make_optimizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {"images": gen_synthetic_image_dirs(str(root / "images"), n_images=5, size=24,
                                               seed=0),
            "videos": gen_synthetic_video_dirs(str(root / "videos"), n_videos=3, depth=4,
                                               size=16),
            "mri": gen_synthetic_mri_dirs(str(root / "mri"), n_volumes=3, slices=4,
                                          size=16, seed=1)}


def _test_loaders(kind, dirs, num_workers, jax=False):
    if kind == "images":
        get = jax_get_data_loader if jax else get_data_loader
        return get([os.path.join(dirs["images"], "test")], batch_size=2, test=True,
                   **({} if jax else {"num_workers": num_workers}))
    if kind == "videos":
        get = jax_get_video_loader if jax else get_video_loader
        return get([os.path.join(dirs["videos"], "test")], batch_size=2, test=True,
                   depth=4, num_workers=num_workers)
    get = jax_get_fastmri_data_loader if jax else get_fastmri_data_loader
    return get([os.path.join(dirs["mri"], "test")], batch_size=2, test=True, depth=3,
               num_workers=num_workers)


@pytest.mark.parametrize("kind", ["images", "videos", "mri"])
def test_test_loaders_with_workers_yield_the_jax_batches(data_dirs, kind):
    """Test mode draws nothing, so two threads assemble exactly JAX's
    sequential batches, in order, epoch after epoch (the pool persists)."""
    ours = _test_loaders(kind, data_dirs, num_workers=2)
    want = [np.asarray(b) for b in _test_loaders(kind, data_dirs, 0, jax=True)]
    for _ in range(2):
        got = list(ours)
        assert len(got) == len(want) == len(ours) > 0
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert ours._pool is not None and ours._pool._max_workers == 2


def test_train_loaders_with_workers_keep_the_jax_epoch_order(data_dirs):
    """Shuffled crops with workers: JAX's epoch order and batch shapes over
    two epochs (which item gets which crop follows the threads' spawn
    order; at num_workers=0 the batches are JAX's bit for bit,
    tests/test_torch_cli_train.py)."""
    d = data_dirs["images"]
    kw = dict(trn_path_list=[os.path.join(d, "train")], val_path_list=[os.path.join(d, "val")],
              tst_path_list=[os.path.join(d, "test")], crop_size=8, batch_size=[2, 1, 1],
              seed=3)
    ours, ref = get_fit_loaders(**kw, num_workers=2)["train"], jax_get_fit_loaders(**kw)["train"]
    orders = [[list(sel) for sel in loader._batches()] for loader in (ours, ref, ours, ref)]
    assert orders[0] == orders[1] and orders[2] == orders[3] and orders[0] != orders[2]
    ours = get_fit_loaders(**kw, num_workers=2)["train"]
    for _ in range(2):
        assert [b.shape for b in ours] == [(2, 1, 8, 8)] * 2


class _Gated:
    """A dataset of constant items that records how many were read; items
    from index 2 on wait for `gate`, so a one-thread pool is held inside the
    second batch while the test stops the epoch."""

    def __init__(self, n):
        self.n, self.reads = n, 0
        self.lock, self.gate = threading.Lock(), threading.Event()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i >= 2:
            assert self.gate.wait(timeout=30)
        with self.lock:
            self.reads += 1
        return np.full((1, 2, 2), i, np.float32)


def _stopped_after_one_batch(make_epoch):
    """Start an epoch of a one-worker loader (prefetch 2: three batches
    submitted), take one batch, close the epoch, then let the worker go.
    Returns (the loader, the dataset, the batch). Closing cancels the third
    batch, and the second unless the worker had taken it up: 2 or 4 reads,
    not 6."""
    ds = _Gated(40)
    loader = DataLoader(ds, batch_size=2, num_workers=1, prefetch=2)
    epoch = make_epoch(loader)
    first = next(epoch)
    epoch.close()
    ds.gate.set()
    loader._pool.submit(lambda: None).result()  # the pool has drained
    return loader, ds, first


def test_worker_loader_cancels_queued_batches_when_stopped_early():
    """Closing an epoch after one batch drops the batches still queued; the
    next epoch runs whole on the same pool."""
    loader, ds, first = _stopped_after_one_batch(iter)
    assert first[:, 0, 0, 0].tolist() == [0, 1] and ds.reads in (2, 4)
    pool = loader._pool
    got = list(loader)
    assert len(got) == 20 and loader._pool is pool
    np.testing.assert_array_equal(np.concatenate(got)[:, 0, 0, 0], np.arange(40))


def test_thread_safe_rng_spawns_distinct_children_under_contention():
    """More threads than cores spawning children with a short switch
    interval: every child's spawn key is distinct (a lost update of the
    root's spawn counter would repeat one)."""
    rng, keys, lock = ThreadSafeRng(0), [], threading.Lock()

    def spawn():
        for _ in range(200):
            key = rng().bit_generator.seed_seq.spawn_key
            with lock:
                keys.append(key)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=spawn) for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert len(keys) == len(set(keys)) == 200 * len(threads)


def test_device_prefetch_on_the_cpu_yields_the_batches():
    batches = [np.random.default_rng(i).uniform(size=(2, 1, 3, 4)) for i in range(5)]
    got = list(device_prefetch(batches, size=2, device="cpu"))
    assert len(got) == 5
    for a, b in zip(got, batches):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert torch.equal(a, torch.as_tensor(b, dtype=torch.float32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if not torch.cuda.is_available():  # no device given: the card, or a raise
            next(device_prefetch(batches))


def test_device_prefetch_stops_cleanly_mid_epoch():
    """Closing the prefetch generator closes the loader's epoch: its queued
    batches are cancelled and the next epoch is whole."""
    loader, ds, first = _stopped_after_one_batch(
        lambda loader: device_prefetch(loader, device="cpu"))
    assert first[:, 0, 0, 0].tolist() == [0.0, 1.0] and ds.reads in (2, 4)
    assert len(list(device_prefetch(loader, device="cpu"))) == 20


def test_fit_and_fit_csr_histories_do_not_depend_on_the_workers(data_dirs):
    """fit (video) and fit_csr (fastMRI volumes) on test-mode loaders: the
    same history with two workers as without."""
    videos = os.path.join(data_dirs["videos"], "test")
    mri = os.path.join(data_dirs["mri"], "test")
    runs = {}
    for workers in (0, 2):
        for name, cls, cfg, loader in (
                ("video", CDLNetVideo, dict(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True),
                 lambda: get_video_loader([videos], batch_size=2, depth=4,
                                          num_workers=workers)),
                ("csr", CDLNetCSR, dict(K=2, M=4, P=3, s=2, adaptive=True),
                 lambda: get_fastmri_data_loader([mri], batch_size=2, depth=3,
                                                 num_workers=workers))):
            model = cls(**cfg).init(torch.Generator().manual_seed(0))
            opt = make_optimizer(1e-3)
            loaders = {"train": loader(), "val": loader(), "test": loader()}
            run = fit if name == "video" else fit_csr
            _, runs[name, workers] = run(
                model, opt, opt.init(dict(model.named_parameters())), loaders,
                save_dir=os.path.join(str(data_dirs["videos"]), f"run_{name}_{workers}"),
                epochs=2, noise_std=(20, 30), verbose=False)
    for name in ("video", "csr"):
        assert runs[name, 2] == runs[name, 0]
        assert [(e, ph) for e, ph, _ in runs[name, 0]] == [
            (1, "train"), (1, "val"), (2, "train"), (2, "val"), (2, "test")]


@pytest.mark.parametrize("mtype,loaders", [
    ("CDLNet", {}), ("CDLNetVideo", {}), ("CDLNet_CSR", {"PDFS": True})])
def test_train_cli_passes_num_workers_on(data_dirs, mtype, loaders):
    key = {"CDLNet": "images", "CDLNetVideo": "videos"}.get(mtype, "mri")
    args = {"type": mtype, "train": {"loaders": dict(
        {f"{k}_path_list": [os.path.join(data_dirs[key], split)]
         for k, split in (("trn", "train"), ("val", "val"), ("tst", "test"))},
        crop_size=8, depth=3, batch_size=[1, 1, 1], num_workers=3, **loaders)}}
    built, _ = cli_train.make_loaders(args)
    train = getattr(built["train"], "loader", built["train"])
    assert train.num_workers == 3 and built["val"].num_workers == 0
