"""cdlnet_tpu_torch's trace and debug switches on the CPU (utils.py:
trace_span, maybe_start_trace / stop_trace on CDLNET_PROFILE_DIR,
setup_debug and check_finite on CDLNET_DEBUG_NANS; kernels/_build.py on
CDLNET_LOG_COMPILES), the counterparts of cdlnet_tpu/utils.py's: a
one-epoch fit traced through the host loop and the device epoch, NaNs in a
backward and in fit's and fit_csr's losses, each nvcc call of a build
logged (with a stand-in nvcc, so that the test runs without the CUDA
toolkit), and the CLIs and the server turning the switches on first."""

import json
import logging
import os
import stat
import sys
import threading

import numpy as np
import pytest
import torch

from cdlnet_tpu.utils import maybe_start_trace as jax_maybe_start_trace
from cdlnet_tpu_torch import server, utils
from cdlnet_tpu_torch.cli import analyze, analyze3d, analyzemri
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.data.images import ImageDataset
from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng
from cdlnet_tpu_torch.kernels import _build
from cdlnet_tpu_torch.models import CDLNet, CDLNetCSR
from cdlnet_tpu_torch.train.fit import fit
from cdlnet_tpu_torch.train.fit_csr import fit_csr
from cdlnet_tpu_torch.train.optim import make_optimizer

SWITCHES = ("CDLNET_PROFILE_DIR", "CDLNET_DEBUG_NANS", "CDLNET_LOG_COMPILES")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _switches_off(monkeypatch):
    """Each test starts with every switch unset and leaves anomaly mode
    as it found it."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    anomaly = torch.is_anomaly_enabled()
    yield
    torch.autograd.set_detect_anomaly(anomaly)


def _images(n, size=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.2, 0.8, (1, size, size)).astype(np.float32) for _ in range(n)]


def _image_loader(images, crop=16, batch=2):
    """A stageable training loader (fit's device epoch takes it)."""
    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [str(i) for i in range(len(images))]
    ds.images, ds.root_dirs, ds.crop_size, ds.augment = images, [], crop, True
    ds.rng = ThreadSafeRng(0)
    return DataLoader(ds, batch_size=batch, shuffle=True, drop_last=True)


def _fit_2d(tmp_path, train, epochs=1):
    model = CDLNet(K=2, M=4, P=3, s=1, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    val = [np.stack(_images(2, 16, seed=1))]
    return fit(model, opt, opt.init(dict(model.named_parameters())),
               {"train": train, "val": val, "test": val}, save_dir=str(tmp_path / "run"),
               epochs=epochs, noise_std=(20, 30), val_freq=1, save_freq=1,
               backtrack_thresh=None, verbose=False, workload="2d")


def _events(trace_dir):
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(trace_dir, files[0])) as fh:
        return json.load(fh)["traceEvents"]


def _beneath(events, span):
    """The names of the operator events inside the first `span` event's
    time range."""
    s = next(e for e in events if e.get("name") == span and e.get("ph") == "X")
    lo, hi = s["ts"], s["ts"] + s["dur"]
    return {e["name"] for e in events
            if e.get("ph") == "X" and e is not s and lo <= e["ts"] <= hi}


# --- CDLNET_PROFILE_DIR ---

def test_maybe_start_trace_is_false_without_the_variable():
    assert utils.maybe_start_trace() is False
    assert jax_maybe_start_trace() is False
    with pytest.raises(RuntimeError, match="no trace"):
        utils.stop_trace()


def test_trace_span_without_a_profiler_is_a_plain_context():
    with utils.trace_span("train_step"):
        y = torch.ones(3) * 2
    assert torch.equal(y, torch.full((3,), 2.0))


# --- the span recorder (utils.trace_span, recorded_spans, clear_spans) ---

@pytest.fixture
def cpu_profile():
    """A CPU-only torch.profiler session, the recorder cleared first."""
    utils.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield prof
    utils.clear_spans()


def _named(spans):
    return [s[0] for s in spans]


def test_trace_span_without_a_profiler_records_nothing():
    utils.clear_spans()
    spans = [utils.trace_span(n) for n in ("a", "b")]
    assert spans[0] is spans[1]
    with spans[0], spans[1]:
        pass
    assert utils.recorded_spans() == []


def test_nested_spans_record_parent_and_root(cpu_profile):
    with utils.trace_span("request"):
        with utils.trace_span("input"):
            pass
        with utils.trace_span("forward"):
            with utils.trace_span("loop"):
                pass
    with utils.trace_span("request"):
        pass
    spans = utils.recorded_spans()
    assert _named(spans) == ["request", "input", "forward", "loop", "request"]
    assert [(s[3], s[4]) for s in spans] == [(-1, 0), (0, 0), (0, 0), (2, 0), (-1, 4)]
    for name, start, end, parent, _ in spans:
        assert start <= end
        if parent >= 0:
            assert spans[parent][1] <= start and end <= spans[parent][2]
    assert utils.recorded_spans() == spans  # reading does not clear
    utils.clear_spans()
    assert utils.recorded_spans() == []


def test_threads_keep_their_own_span_stacks(cpu_profile):
    """Threads open spans at once (a short switch interval interleaves
    them): each span's parent and root are its own thread's."""
    n_threads, n_spans = 8, 50
    interval = sys.getswitchinterval()
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=10)
        for _ in range(n_spans):
            with utils.trace_span(f"outer{i}"):
                with utils.trace_span(f"inner{i}"):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = utils.recorded_spans()
    assert len(spans) == 2 * n_threads * n_spans
    for j, (name, _, end, parent, root) in enumerate(spans):
        assert end is not None
        if name.startswith("outer"):
            assert (parent, root) == (-1, j)
        else:
            assert spans[parent][0] == "outer" + name[len("inner"):] and root == parent


def test_spans_past_the_cap_are_counted_not_kept(cpu_profile, monkeypatch):
    monkeypatch.setattr(utils, "SPAN_CAP", 3)
    for _ in range(5):
        with utils.trace_span("s"):
            pass
    assert len(utils.recorded_spans()) == 3 and utils.spans_dropped == 2
    utils.clear_spans()
    assert utils.spans_dropped == 0


def _within(spans, i):
    """The names of the spans whose parent is span i, in order."""
    return [s[0] for s in spans if s[3] == i]


def test_denoise_video_records_a_request_tree(cpu_profile):
    """A served clip on the CPU (the kernels' plain versions): one
    serve_request holding its stages in order, the fused loop's operands and
    launches inside serve_forward, each child inside its parent's bounds."""
    from cdlnet_tpu_torch.models import CDLNetVideo
    from cdlnet_tpu_torch.serve import Denoiser

    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True, backend="cuda")
    model.init(torch.Generator().manual_seed(0), init=False)
    clip = np.random.default_rng(0).uniform(0.2, 0.8, (4, 6, 10)).astype(np.float32)
    out = Denoiser(model, bucket=8).denoise_video(clip, sigma=25)
    assert out.shape == clip.shape
    spans = utils.recorded_spans()
    assert spans[0][0] == "serve_request" and sum(s[3] == -1 for s in spans) == 1
    assert _within(spans, 0) == ["serve_input", "serve_forward", "serve_fetch",
                                 "serve_output"]
    fwd = _named(spans).index("serve_forward")
    assert _within(spans, fwd) == ["lista3d_operands", "lista3d_loop"]
    for name, start, end, parent, root in spans:
        assert root == 0 and start <= end
        if parent >= 0:
            assert spans[parent][1] <= start and end <= spans[parent][2]
    children = [s for s in spans if s[3] == 0]
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


def test_epoch_runner_records_its_epochs(cpu_profile):
    """An eager epoch runner on the CPU: per epoch one train_epoch_scan
    holding one train_epoch_begin, `steps` train_epoch_step and the losses'
    copy."""
    from cdlnet_tpu_torch.train.device_data import DeviceImageCorpus, make_epoch_runner
    from cdlnet_tpu_torch.train.fit import make_train_step

    model = CDLNet(K=2, M=4, P=3, s=1, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    step, _ = make_train_step(model, opt, workload="2d", noise_std=(20, 30))
    corpus = DeviceImageCorpus(_images(6), 16, 2, device="cpu")
    runner = make_epoch_runner(corpus, step, model, graph=False)
    st, g = opt.init(dict(model.named_parameters())), torch.Generator().manual_seed(1)
    for _ in range(2):
        runner(st, g)
    spans = utils.recorded_spans()
    roots = [i for i, s in enumerate(spans) if s[3] == -1]
    assert [spans[i][0] for i in roots] == ["train_epoch_scan"] * 2
    for i in roots:
        assert _within(spans, i) == (["train_epoch_begin"]
                                     + ["train_epoch_step"] * runner.steps
                                     + ["train_epoch_losses"])


def test_start_and_stop_write_a_chrome_trace(tmp_path, monkeypatch):
    d = tmp_path / "prof" / "nested"
    monkeypatch.setenv("CDLNET_PROFILE_DIR", str(d))
    assert utils.maybe_start_trace("cpu") is True
    with utils.trace_span("my_span"):
        torch.nn.functional.conv2d(torch.ones(1, 1, 8, 8), torch.ones(2, 1, 3, 3))
    path = utils.stop_trace()
    assert os.path.dirname(path) == str(d) and os.path.exists(path)
    assert "aten::conv2d" in _beneath(_events(d), "my_span")


def test_one_epoch_fit_traces_its_train_steps(tmp_path, monkeypatch):
    """fit on a host loop (a list of batches): the first trained epoch in
    the trace, each step a train_step span with the step's operators
    beneath it; the eval phases after it are not traced."""
    monkeypatch.setenv("CDLNET_PROFILE_DIR", str(tmp_path / "prof"))
    batches = [np.stack(_images(2, seed=s)) for s in range(3)]
    _, history = _fit_2d(tmp_path, batches)
    assert [ph for _, ph, _ in history] == ["train", "val", "test"]
    events = _events(tmp_path / "prof")
    steps = [e for e in events if e.get("name") == "train_step"]
    assert len(steps) == 3
    assert not any(e.get("name") in ("val_step", "test_step") for e in events)
    assert "aten::conv2d" in _beneath(events, "train_step")


def test_one_epoch_fit_traces_its_device_epoch(tmp_path, monkeypatch):
    """fit on a stageable loader (the device epoch, train/device_data.py):
    one train_epoch_scan span over the epoch's steps."""
    monkeypatch.setenv("CDLNET_PROFILE_DIR", str(tmp_path / "prof"))
    _fit_2d(tmp_path, _image_loader(_images(6)))
    events = _events(tmp_path / "prof")
    assert sum(e.get("name") == "train_epoch_scan" for e in events) == 1
    assert not any(e.get("name") == "train_step" for e in events)
    assert "aten::conv2d" in _beneath(events, "train_epoch_scan")


def test_only_the_first_trained_epoch_is_traced(tmp_path, monkeypatch):
    monkeypatch.setenv("CDLNET_PROFILE_DIR", str(tmp_path / "prof"))
    batches = [np.stack(_images(2, seed=s)) for s in range(2)]
    _fit_2d(tmp_path, batches, epochs=2)
    assert sum(e.get("name") == "train_step" for e in _events(tmp_path / "prof")) == 2


# --- CDLNET_DEBUG_NANS ---

def _nan_backward():
    """A graph whose forward is finite and whose backward makes a NaN: the
    gradient of sqrt at 0 (inf) times the 0 that follows it."""
    a = torch.zeros(2, requires_grad=True)
    b = (a.sqrt() * 0.0).sum()
    assert torch.isfinite(b)
    return torch.autograd.grad(b, a)[0]


def test_setup_debug_without_the_variable_changes_nothing():
    utils.setup_debug()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(_nan_backward()).all()


def test_debug_nans_raises_at_the_backward_op_that_made_a_nan(monkeypatch):
    monkeypatch.setenv("CDLNET_DEBUG_NANS", "1")
    utils.setup_debug()
    assert torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
        _nan_backward()


def test_check_finite_only_under_the_switch(monkeypatch):
    bad = torch.tensor([1.0, float("inf")])
    utils.check_finite(bad, "off")  # no switch: no check
    monkeypatch.setenv("CDLNET_DEBUG_NANS", "1")
    utils.check_finite(torch.tensor([1.0, 2.0]), "finite")
    with pytest.raises(FloatingPointError, match="non-finite loss at step 3"):
        utils.check_finite(bad, "at step 3")


@pytest.mark.parametrize("device_epoch", [False, True], ids=["host loop", "device epoch"])
def test_fit_raises_on_a_non_finite_loss_under_debug_nans(tmp_path, monkeypatch,
                                                         device_epoch):
    """A NaN in a training batch: fit raises FloatingPointError under the
    switch, where without it the NaN epoch is only recorded."""
    images = _images(6)
    images[0][:] = np.nan  # every crop of it
    train = (_image_loader(images) if device_epoch
             else [np.stack(images[:2]), np.stack(images[2:4])])
    _, history = _fit_2d(tmp_path / "off", train)
    assert np.isnan(history[0][2])
    monkeypatch.setenv("CDLNET_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _fit_2d(tmp_path / "on", train)


@pytest.mark.parametrize("debug", [False, True])
def test_debug_nans_runs_the_device_epoch_without_a_graph(tmp_path, monkeypatch, debug):
    """Anomaly mode reads the device after every backward op, which a CUDA
    graph capture forbids: under the switch fit asks its epoch runner for
    eager steps (graph=False); without it, the default (a graph on the
    card)."""
    from cdlnet_tpu_torch.train import device_data

    seen = []
    make = device_data.make_epoch_runner

    def spy(*args, graph=None):
        seen.append(graph)
        return make(*args, graph=graph)

    monkeypatch.setattr(device_data, "make_epoch_runner", spy)
    if debug:
        monkeypatch.setenv("CDLNET_DEBUG_NANS", "1")
    _fit_2d(tmp_path, _image_loader(_images(4)))
    assert seen == [False if debug else None]


def test_fit_csr_raises_on_a_non_finite_loss_under_debug_nans(tmp_path, monkeypatch):
    model = CDLNetCSR(K=2, M=4, P=3, s=1)
    model.init(torch.Generator().manual_seed(1))
    opt = make_optimizer(1e-3, clip_grad=1.0)
    vols = np.random.default_rng(2).uniform(0.2, 0.8, (1, 1, 2, 8, 8)).astype(np.float32)
    vols[0, 0, 1, 3, 3] = np.inf
    loaders = {"train": [vols], "val": [], "test": [vols]}
    kw = dict(epochs=1, noise_std=(20, 30), verbose=False)
    _, history = fit_csr(model, opt, opt.init(dict(model.named_parameters())), loaders,
                         save_dir=str(tmp_path / "off"), **kw)
    assert not np.isfinite(history[0][2])
    monkeypatch.setenv("CDLNET_DEBUG_NANS", "1")
    with pytest.raises(FloatingPointError, match="epoch 1 train step 1"):
        fit_csr(model, opt, opt.init(dict(model.named_parameters())), loaders,
                save_dir=str(tmp_path / "on"), **kw)


# --- CDLNET_LOG_COMPILES ---

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
if any(a.endswith("bad.cu") for a in args):
    print("bad.cu(1): error: a stand-in compile error")
    sys.exit(2)
out = args[args.index("-o") + 1]
open(out, "w").write("built\\n")
print("ptxas info    : Used 1 registers")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """_build.build against a stand-in nvcc (a script that writes its -o
    file) on two sources in a directory of their own."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu"):
        (src / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    return src


def _nvcc_records(caplog):
    return [r.getMessage() for r in caplog.records if r.name == _build.__name__]


def test_log_compiles_logs_each_nvcc_call(fake_build, caplog, monkeypatch):
    caplog.set_level(logging.WARNING, logger=_build.__name__)
    monkeypatch.setenv("CDLNET_LOG_COMPILES", "1")
    so, seconds = _build.build()
    assert so.exists() and seconds > 0
    msgs = _nvcc_records(caplog)
    assert len(msgs) == 3, msgs
    for label, msg in zip(("a.cu", "b.cu", f"link {so.name}"), sorted(msgs)):
        assert msg.startswith(f"nvcc {label}: ") and msg.endswith(" s, ok"), msg
    caplog.clear()
    assert _build.build() == (so, 0.0)  # a cached library: no compilation, no line
    assert not _nvcc_records(caplog)


def test_log_compiles_off_logs_nothing_and_failures_are_logged(fake_build, caplog,
                                                                monkeypatch):
    caplog.set_level(logging.WARNING, logger=_build.__name__)
    so, _ = _build.build()
    assert so.exists() and not _nvcc_records(caplog)
    (fake_build / "bad.cu").write_text("// bad\n")
    monkeypatch.setenv("CDLNET_LOG_COMPILES", "1")
    with pytest.raises(RuntimeError, match="stand-in compile error"):
        _build.build()
    assert any(m.startswith("nvcc bad.cu: ") and m.endswith("failed (exit 2)")
               for m in _nvcc_records(caplog))


# --- the entry points turn the switches on first ---

class _Called(Exception):
    pass


@pytest.mark.parametrize("module,call", [
    (cli_train, lambda m: m.main({})),
    (analyze, lambda m: m.main(None, {})),
    (analyze3d, lambda m: m.main(None, {})),
    (analyzemri, lambda m: m.main(None, {})),
    (server, lambda m: m.main(["no-model-dir", "--device", "cpu"])),
], ids=["train", "analyze", "analyze3d", "analyzemri", "server"])
def test_entry_points_call_setup_debug_first(module, call, monkeypatch):
    """Each CLI's and the server's main calls setup_debug before it reads
    its arguments' contents (as the JAX package's call setup_debug through
    setup_compilation_cache)."""
    def called():
        raise _Called

    monkeypatch.setattr(module, "setup_debug", called, raising=False)
    if module is server:
        monkeypatch.setattr(utils, "setup_debug", called)
    with pytest.raises(_Called):
        call(module)
