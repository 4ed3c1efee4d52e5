"""One-dispatch training epochs on the CPU (train/device_data.py and
fit(device_scan=...)): the staged corpora's batches against the JAX
package's DeviceImageCorpus / DeviceClipCorpus.sample on the same draws,
the qualification rules against JAX's on the same loaders, the epoch
runner against the train step on its own batches, and fit's device_scan
cases of the JAX package's tests (tests/test_train.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cdlnet_tpu.data.images import get_data_loader as jax_get_data_loader
from cdlnet_tpu.data.video import get_video_loader as jax_get_video_loader
from cdlnet_tpu.train import device_data as jdd
from cdlnet_tpu_torch.data.images import ImageDataset, get_data_loader
from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_image_dirs, gen_synthetic_video_dirs
from cdlnet_tpu_torch.data.video import get_video_fit_loaders, get_video_loader
from cdlnet_tpu_torch.models import CDLNet, CDLNetVideo, DnCNN
from cdlnet_tpu_torch.train import device_data as tdd
from cdlnet_tpu_torch.train.fit import fit, make_train_step
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


def _images(n, shape=(40, 48), seed=0, portrait_every=2):
    """n (1, H, W) images in [0.2, 0.8), every `portrait_every`-th one
    transposed to portrait."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        im = rng.uniform(0.2, 0.8, (1, *shape)).astype(np.float32)
        if portrait_every and i % portrait_every:
            im = np.ascontiguousarray(im.transpose(0, 2, 1))
        out.append(im)
    return out


def _image_loader(images, crop=32, batch=2, shuffle=True, drop_last=True):
    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [str(i) for i in range(len(images))]
    ds.images, ds.root_dirs, ds.crop_size, ds.augment = images, [], crop, True
    ds.rng = ThreadSafeRng(0)
    return DataLoader(ds, batch_size=batch, shuffle=shuffle, drop_last=drop_last)


def _eval_loaders(n=2, size=32):
    imgs = np.stack(_images(n, (size, size), seed=9, portrait_every=0))
    return {"val": [imgs], "test": [imgs[:1]]}


# --- the staged batches against the JAX package's on the same draws ---

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_image_assemble_matches_jax_sample(seed):
    """JAX's offsets and flips, re-drawn from the same key with the same
    jax.random calls, through the port's assemble: bitwise JAX's sample,
    portrait images (staged transposed) among them."""
    images = _images(6, (40, 52)) + _images(2, (44, 44), seed=3, portrait_every=0)
    crop, B = 24, 4
    ref = jdd.DeviceImageCorpus(images, crop, B)
    port = tdd.DeviceImageCorpus(images, crop, B, device="cpu")
    np.testing.assert_array_equal(port.images.numpy(), np.asarray(ref.images))
    np.testing.assert_array_equal(port.sizes.numpy(), np.asarray(ref.sizes))
    np.testing.assert_array_equal(port.transposed.numpy(), np.asarray(ref.transposed))
    key = jax.random.PRNGKey(seed)
    kperm, kb = jax.random.split(key)
    idx = ref.epoch_perm(kperm)[:B]
    want = np.asarray(ref.sample(kb, idx, *ref.arrays()))
    kh, kw, kf1, kf2 = jax.random.split(kb, 4)
    hw = ref.sizes[idx]
    oh = (jax.random.uniform(kh, (B,)) * (hw[:, 0] - crop + 1)).astype(jnp.int32)
    ow = (jax.random.uniform(kw, (B,)) * (hw[:, 1] - crop + 1)).astype(jnp.int32)
    fh = jax.random.bernoulli(kf1, 0.5, (B,))
    fv = jax.random.bernoulli(kf2, 0.5, (B,))
    t = lambda a, dt: torch.from_numpy(np.array(a)).to(dt)
    got = port.assemble(t(idx, torch.int64), t(oh, torch.int64), t(ow, torch.int64),
                        t(fh, torch.bool), t(fv, torch.bool))
    assert got.shape == (B, 1, crop, crop)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_clip_draws(ref, key, idx):
    """The draws of JAX's DeviceClipCorpus.sample(key, idx), made with its
    own jax.random calls, as the port's assemble takes them."""
    D = ref.depth
    cw, ch = ref.crop
    H, W = ref.frame_hw
    keys = jax.random.split(key, len(idx))
    names = ("walk", "start_w", "x0", "y0", "steps", "start_c", "rev", "do_crop", "cx", "cy")
    out = {k: [] for k in names}
    for i, v in enumerate(np.asarray(idx)):
        n = int(ref.nframes[v])
        k = jax.random.split(keys[i], 8)
        out["walk"].append(jax.random.uniform(k[0]) < ref.aug_prob)
        out["start_w"].append(jax.random.randint(k[1], (), 0, n))
        out["x0"].append(jax.random.randint(k[2], (), 0, W - cw + 1))
        out["y0"].append(jax.random.randint(k[3], (), 0, H - ch + 1))
        out["steps"].append(jax.random.randint(k[4], (2, D), -ref.max_shift, ref.max_shift + 1))
        out["start_c"].append(jax.random.randint(k[5], (), 0, n - D + 1))
        out["rev"].append(jax.random.uniform(k[6]) < 0.5)
        out["do_crop"].append(jax.random.uniform(k[7]) < ref.crop_ratio)
        kx, ky = jax.random.split(jax.random.fold_in(keys[i], 99))
        out["cx"].append(jax.random.randint(kx, (), 0, W - cw + 1))
        out["cy"].append(jax.random.randint(ky, (), 0, H - ch + 1))
    as_t = lambda vals: torch.from_numpy(np.stack([np.asarray(v) for v in vals]))
    draws = [as_t(out[k]) for k in names]
    return [d.to(torch.bool) if d.dtype == torch.bool else d.to(torch.int64) for d in draws]


@pytest.mark.parametrize("branch,aug_prob,crop_ratio", [
    ("walk", 1.0, 0.5), ("crop", 0.0, 1.0), ("resize", 0.0, 0.0)])
def test_clip_assemble_matches_jax_sample(branch, aug_prob, crop_ratio):
    """Each protocol branch of DeviceClipCorpus on JAX's draws, videos of
    unequal lengths: the wrapping random walk and the shared crop bitwise
    JAX's sample, the whole-frame resize (antialiased bilinear, as
    jax.image.resize) within 1e-5."""
    rng = np.random.default_rng(4)
    videos = [rng.uniform(0, 1, (1, n, 36, 44)).astype(np.float32) for n in (9, 12, 10, 14)]
    args = (6, (16, 12), 3, crop_ratio, aug_prob, 4)
    ref = jdd.DeviceClipCorpus(videos, *args)
    port = tdd.DeviceClipCorpus(videos, *args, device="cpu")
    np.testing.assert_array_equal(port.videos.numpy(), np.asarray(ref.videos))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        kperm, kb = jax.random.split(key)
        idx = ref.epoch_perm(kperm)[:3]
        want = np.asarray(ref.sample(kb, idx, *ref.arrays()))
        draws = _jax_clip_draws(ref, kb, idx)
        got = port.assemble(torch.from_numpy(np.asarray(idx)).to(torch.int64), *draws).numpy()
        assert got.shape == want.shape == (3, 1, 6, 12, 16)
        if branch == "resize":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


# --- which loaders qualify, against JAX's rules on the same loaders ---

@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan_data")
    images = str(root / "images")
    gen_synthetic_image_dirs(images, n_images=5, size=40, seed=0)
    videos = str(root / "videos")
    gen_synthetic_video_dirs(videos, n_videos=3, depth=6, size=24)
    mixed = root / "mixed"
    gen_synthetic_video_dirs(str(mixed / "a"), n_videos=2, depth=6, size=24, splits=("train",))
    gen_synthetic_video_dirs(str(mixed / "b"), n_videos=1, depth=6, size=20, splits=("train",))
    return {"images": os.path.join(images, "train"), "videos": os.path.join(videos, "train"),
            "mixed": [str(mixed / "a" / "train"), str(mixed / "b" / "train")]}


QUALIFY = {
    "image": ("image", "2d", dict(batch_size=2, crop_size=16, test=False)),
    "image_test_loader": ("image", "2d", dict(batch_size=2, crop_size=16, test=True)),
    "image_batch_over_corpus": ("image", "2d", dict(batch_size=6, crop_size=16, test=False)),
    "image_crop_over_image": ("image", "2d", dict(batch_size=2, crop_size=48, test=False)),
    "image_as_3d": ("image", "3d", dict(batch_size=2, crop_size=16, test=False)),
    "image_as_mri": ("image", "mri", dict(batch_size=2, crop_size=16, test=False)),
    "video": ("video", "3d", dict(batch_size=2, crop_size=16, depth=4, test=False)),
    "video_test_loader": ("video", "3d", dict(batch_size=2, crop_size=16, depth=4, test=True)),
    "video_shorter_than_depth": ("video", "3d", dict(batch_size=2, crop_size=16, depth=8,
                                                     test=False)),
    "video_crop_over_frame": ("video", "3d", dict(batch_size=2, crop_size=32, depth=4,
                                                  test=False)),
    "video_batch_over_corpus": ("video", "3d", dict(batch_size=4, crop_size=16, depth=4,
                                                    test=False)),
    "video_over_cap": ("video", "3d", dict(batch_size=2, crop_size=16, depth=4, test=False)),
    "video_mixed_frame_sizes": ("mixed", "3d", dict(batch_size=2, crop_size=16, depth=4,
                                                    test=False)),
    "video_as_2d": ("video", "2d", dict(batch_size=2, crop_size=16, depth=4, test=False)),
}


@pytest.mark.parametrize("case", list(QUALIFY))
def test_corpus_qualification_matches_jax(case, data_dirs, monkeypatch):
    """corpus_from_loader on the port's loader and JAX's on the JAX
    package's, built alike: both stage, or both keep the host loop; the
    staged arrays equal."""
    kind, workload, kw = QUALIFY[case]
    if case == "video_over_cap":
        monkeypatch.setenv("CDLNET_CORPUS_MAX_MB", "0.01")
    if kind == "image":
        dirs = [data_dirs["images"]]
        port = get_data_loader(dirs, **kw)
        ref = jax_get_data_loader(dirs, **kw)
    else:
        dirs = data_dirs["mixed"] if kind == "mixed" else [data_dirs["videos"]]
        port = get_video_loader(dirs, **kw)
        ref = jax_get_video_loader(dirs, **kw)
    got = tdd.corpus_from_loader(port, workload, device="cpu")
    want = jdd.corpus_from_loader(ref, workload)
    assert (got is None) == (want is None), case
    if case in ("image", "video"):
        assert got is not None
    if got is not None:
        staged = got.images if kind == "image" else got.videos
        np.testing.assert_array_equal(
            staged.numpy(), np.asarray(want.images if kind == "image" else want.videos))
        assert got.steps_per_epoch == want.steps_per_epoch


@pytest.mark.parametrize("what", ["list", "unshuffled", "not_drop_last"])
def test_corpus_rejects_host_only_loaders(what):
    """A list of batches, an unshuffled loader (a fixed epoch order) and one
    that keeps its last partial batch keep the host loop, as in JAX."""
    images = _images(4, (40, 40))
    if what == "list":
        port, ref = [np.stack(images[:2])], [np.stack(images[:2])]
    else:
        kw = dict(shuffle=what != "unshuffled", drop_last=what != "not_drop_last")
        port = _image_loader(images, **kw)
        from cdlnet_tpu.data.images import ImageDataset as JaxImageDataset
        from cdlnet_tpu.data.loader import DataLoader as JaxDataLoader
        from cdlnet_tpu.data.loader import ThreadSafeRng as JaxRng

        ds = JaxImageDataset.__new__(JaxImageDataset)
        ds.image_paths = [str(i) for i in range(4)]
        ds.images, ds.root_dirs, ds.crop_size, ds.augment = images, [], 32, True
        ds.rng = JaxRng(0)
        ref = JaxDataLoader(ds, batch_size=2, **kw)
    assert tdd.corpus_from_loader(port, "2d", device="cpu") is None
    assert jdd.corpus_from_loader(ref, "2d") is None


# --- the epoch runner against the train step on its own batches ---

def _runner_case(kind):
    """(model, corpus, make_train_step keywords) of a small 2D, video or
    DnCNN config."""
    if kind == "2d":
        model = CDLNet(K=3, M=8, P=5, s=2, adaptive=True)
        corpus = tdd.DeviceImageCorpus(_images(6, (36, 44)), 24, 2, device="cpu")
        return model, corpus, dict(workload="2d", noise_std=(20, 30))
    if kind == "video":
        rng = np.random.default_rng(5)
        videos = [rng.uniform(0, 1, (1, n, 28, 36)).astype(np.float32) for n in (8, 10, 9, 8)]
        model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True)
        corpus = tdd.DeviceClipCorpus(videos, 4, (16, 16), 2, 0.5, 0.3, 3, device="cpu")
        return model, corpus, dict(workload="3d", noise_std=(20, 30))
    model = DnCNN(K=4, M=8)
    corpus = tdd.DeviceImageCorpus(_images(6, (36, 44)), 20, 3, device="cpu")
    return model, corpus, dict(workload="2d", noise_std=25)


@pytest.mark.parametrize("kind", ["2d", "video", "dncnn"])
def test_runner_matches_train_step_on_its_batches(kind):
    """An epoch of make_epoch_runner (eager on the CPU) against the same
    steps composed by hand: the epoch's permutation, each batch drawn and
    assembled from the same generator, then train_step. Losses, parameters,
    statistics and Adam state bitwise."""
    model, corpus, kw = _runner_case(kind)
    model.init(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(1e-3, clip_grad=0.05)
    out = {}
    for route in ("runner", "by_hand"):
        model.load_state_dict(init)
        st = opt.init(dict(model.named_parameters()))
        step, _ = make_train_step(model, opt, **kw)
        g = torch.Generator().manual_seed(7)
        if route == "runner":
            runner = tdd.make_epoch_runner(corpus, step, model)
            assert not runner.graphed and runner.steps == corpus.steps_per_epoch
            losses = runner(st, g)
        else:
            perm = corpus.epoch_perm(g)
            B = corpus.batch
            losses = torch.stack([step(st, corpus.sample(perm[i * B:(i + 1) * B], g), g)
                                  for i in range(corpus.steps_per_epoch)])
        out[route] = (losses, {k: v.clone() for k, v in model.state_dict().items()},
                      [st["count"], *st["mu"].values(), *st["nu"].values()])
    (la, sa, aa), (lb, sb, ab) = out["runner"], out["by_hand"]
    assert losses.shape == (corpus.steps_per_epoch,) and torch.isfinite(la).all()
    assert torch.equal(la, lb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(a, b) for a, b in zip(aa, ab))


def test_runner_refuses_a_graph_on_the_cpu():
    model, corpus, kw = _runner_case("2d")
    step, _ = make_train_step(model, make_optimizer(1e-3), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tdd.make_epoch_runner(corpus, step, model, graph=True)


# --- fit(device_scan=...): the JAX package's cases ---

def test_fit_device_scan_epoch_runner(tmp_path):
    """Each training epoch runs through the epoch runner with on-device
    crop/flip assembly; training improves, artifacts follow the host
    loop's protocol (steps a phase, txt, checkpoints), projection holds."""
    loaders = {"train": _image_loader(_images(8)), **_eval_loaders()}
    model = CDLNet(K=3, M=8, P=5, s=1, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    st, history = fit(model, opt, opt.init(dict(model.named_parameters())), loaders,
                      save_dir=str(tmp_path), epochs=5, noise_std=(20, 30), val_freq=5,
                      save_freq=1, verbose=False, device_scan=True, workload="2d")
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert train_psnrs[-1] > train_psnrs[0], train_psnrs
    norms = torch.linalg.vector_norm(model.A.detach().reshape(3 * 8, -1), dim=1)
    assert (norms <= 1 + 1e-4).all() and (model.t >= 0).all()
    assert (tmp_path / "train.txt").exists() and (tmp_path / "net.ckpt.npz").exists()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    train_rows = [r for r in rows if r.get("phase") == "train"]
    assert train_rows and all(r["steps"] == 4 for r in train_rows)
    assert int(st["count"]) == 20


def test_fit_device_scan_true_requires_stageable_loader(tmp_path):
    model = CDLNet(K=2, M=4, P=3, s=1)
    opt = make_optimizer(1e-3)
    loaders = {"train": [np.stack(_images(2, (32, 32), portrait_every=0))], **_eval_loaders()}
    with pytest.raises(ValueError, match="device_scan"):
        fit(model, opt, opt.init(dict(model.named_parameters())), loaders,
            save_dir=str(tmp_path), epochs=1, verbose=False, device_scan=True, workload="2d")


def test_fit_device_scan_stateful_dncnn(tmp_path):
    """A BatchNorm family: the runner's steps update the running
    statistics."""
    loaders = {"train": _image_loader(_images(4, (40, 40), seed=1, portrait_every=0)),
               **_eval_loaders()}
    model = DnCNN(K=4, M=8)
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    _, history = fit(model, opt, opt.init(dict(model.named_parameters())), loaders,
                     save_dir=str(tmp_path), epochs=3, noise_std=25, val_freq=3,
                     verbose=False, device_scan=True, project=False, workload="2d")
    assert not torch.allclose(model.bn_var, torch.ones_like(model.bn_var))
    assert all(np.isfinite(p) for _, _, p in history)


def test_fit_device_scan_video(tmp_path):
    """A video workload: each epoch draws clip batches on the device;
    training improves and the step count is the host loop's (drop_last
    over the videos). Ten epochs where JAX's test runs four: at two steps an
    epoch one epoch's PSNR follows its random clips."""
    root = gen_synthetic_video_dirs(str(tmp_path / "vids"), n_videos=4, depth=8, size=48)
    loaders = get_video_fit_loaders(
        trn_path_list=(os.path.join(root, "train"),), val_path_list=(os.path.join(root, "val"),),
        tst_path_list=(os.path.join(root, "test"),), crop_size=32, batch_size=(2, 1, 1),
        depth=8)
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    _, history = fit(model, opt, opt.init(dict(model.named_parameters())), loaders,
                     save_dir=str(tmp_path / "out"), epochs=10, noise_std=(20, 30),
                     val_freq=10, verbose=False, device_scan=True, workload="3d")
    # two steps an epoch of random clips: the trend over three epochs each end
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert np.mean(train_psnrs[-3:]) > np.mean(train_psnrs[:3]), train_psnrs
    rows = [json.loads(l) for l in open(tmp_path / "out" / "metrics.jsonl")]
    train_rows = [r for r in rows if r.get("phase") == "train"]
    assert train_rows and all(r["steps"] == 2 for r in train_rows)


def test_fit_device_scan_under_dp_mesh(tmp_path):
    """device_scan on a data mesh (one process: the trivial one-rank
    mesh): the mesh's steps run eagerly on the staged batches, and the
    run is bitwise the meshless one."""
    images = _images(16, (40, 40), portrait_every=0)
    params = {}
    for name, mesh in (("mesh", {"data": -1}), ("none", None)):
        loaders = {"train": _image_loader(images, batch=8), **_eval_loaders()}
        model = CDLNet(K=2, M=4, P=3, s=1, adaptive=True)
        model.init(torch.Generator().manual_seed(0))
        opt = make_optimizer(1e-3, clip_grad=0.05)
        _, history = fit(model, opt, opt.init(dict(model.named_parameters())), loaders,
                         save_dir=str(tmp_path / name), epochs=4, noise_std=(20, 30),
                         val_freq=4, verbose=False, device_scan=True, mesh=mesh,
                         workload="2d")
        train_psnrs = [p for e, ph, p in history if ph == "train"]
        assert train_psnrs[-1] > train_psnrs[0], train_psnrs
        params[name] = {k: v.clone() for k, v in model.named_parameters()}
    assert all(torch.equal(params["mesh"][k], params["none"][k]) for k in params["none"])


class _CountingDataset(ImageDataset):
    """An in-memory ImageDataset that counts the items the loader reads."""

    def __init__(self, images, crop):
        self.image_paths = [str(i) for i in range(len(images))]
        self.images, self.root_dirs, self.crop_size, self.augment = images, [], crop, True
        self.rng = ThreadSafeRng(0)
        self.reads = 0

    def __getitem__(self, idx):
        self.reads += 1
        return super().__getitem__(idx)


@pytest.mark.parametrize("device_scan,env,staged", [
    ("auto", None, True), (True, None, True), ("auto", "0", False), (True, "0", False),
    (False, None, False)])
def test_device_scan_default_and_switches(tmp_path, monkeypatch, device_scan, env, staged):
    """fit's default ("auto") and True stage a qualifying loader: its items
    are never read for training; CDLNET_DEVICE_SCAN=0 and False keep the
    host loop, which reads them."""
    if env is not None:
        monkeypatch.setenv("CDLNET_DEVICE_SCAN", env)
    ds = _CountingDataset(_images(4, (40, 40), portrait_every=0), 32)
    loaders = {"train": DataLoader(ds, batch_size=2, shuffle=True, drop_last=True),
               **_eval_loaders()}
    model = CDLNet(K=2, M=4, P=3, s=1, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3)
    kw = {} if device_scan == "auto" else {"device_scan": device_scan}
    _, history = fit(model, opt, opt.init(dict(model.named_parameters())), loaders,
                     save_dir=str(tmp_path), epochs=1, verbose=False, workload="2d", **kw)
    assert (ds.reads == 0) == staged
    assert [ph for _, ph, _ in history] == ["train", "val", "test"]
