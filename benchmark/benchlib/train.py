"""Training cells: replayed epochs over a corpus staged on the device, the
path fit(device_scan="auto") takes: make_train_step, a device corpus and
make_epoch_runner (one step captured into a CUDA graph and replayed).

Set-up builds the one training object (model, optimizer state, corpus,
runner), captures the step, and drives its first CHECK_STEPS steps
through the runner's own calls, recording what each step drew: the corpus
draws, the clean batch, the noisy batch and its noise levels (copies into
the benchmark's buffers, captured with the step, so every replay makes
them). The rest of that epoch ends set-up. The window then runs whole
epochs (runner(opt_state, generator)), reading each epoch's losses as fit
does; it ends at the last read. Each of its epochs starts from the state
set-up left (the parameters, Adam's count and moments, copied back in
place): the steps' work does not depend on where training has gone, and a
long window cannot drive a model at the configuration's learning rate
into overflow. That restart stands in for fit's backtracking, which
restores a checkpoint when a loss turns non-finite: CDLNet at lr 1e-3,
trained on without it, turns non-finite within 700-odd steps on some
seeds, the plain reference in TF32 as well as the program. The draws go
on.

The configuration's "train" group gives batch, crop, depth (clips), lr,
clip_grad, noise_std and, for clips, crop_ratio, aug_prob and max_shift;
its "corpus" group the staged data: {"kind": "video", "videos", "height",
"width"} with the top-level frames_per_video, or {"kind": "image",
"images", "height", "width", "portrait_share"} (landscape sizes).
Traffic keys: kind ("train_epochs").
"""

from __future__ import annotations

import gc
import math
import time

import torch

import work
from benchlib import program, synth
from benchlib.tracing import Trace, stamp
from reference import corpus as ref_corpus
from reference.lista import exact_fp32
from reference.train import train_steps

CHECK_STEPS = 3  # the steps the reference follows


def _video(config: dict, seed: int, v: int, device) -> torch.Tensor:
    c = config["corpus"]
    g = synth.generator(seed, f"video{v}", device)
    return synth.texture(g, config["frames_per_video"], c["height"], c["width"], device)[None]


def _image(config: dict, seed: int, i: int, device) -> torch.Tensor:
    c = config["corpus"]
    g = synth.generator(seed, f"image{i}", device)
    img = synth.texture(g, 1, c["height"], c["width"], device)
    return img.transpose(1, 2) if synth.portrait(c.get("portrait_share"), i) else img


def make_corpus(config: dict, seed: int, device):
    """The program's device corpus holding the benchmark's data."""
    c, train = config["corpus"], config["train"]
    if c["kind"] == "image":
        images = [_image(config, seed, i, device).cpu().numpy() for i in range(c["images"])]
        return program.image_corpus(images, train["crop"], train["batch"], device)
    # the constructor stages host arrays: hand it one zero video for every
    # slot and write the benchmark's videos into the staged tensor in place
    shape = (1, config["frames_per_video"], c["height"], c["width"])
    blank = torch.zeros(shape).numpy()
    corpus = program.clip_corpus([blank] * c["videos"], train, device)
    if tuple(corpus.videos.shape) != (c["videos"],) + shape:
        raise RuntimeError(f"staged videos {tuple(corpus.videos.shape)}, expected "
                           f"{(c['videos'],) + shape}")
    with torch.no_grad():
        for v in range(c["videos"]):
            corpus.videos[v].copy_(_video(config, seed, v, device))
    return corpus


class Recorder:
    """Copies of what each step drew, into buffers of the benchmark's."""

    def __init__(self):
        self.buf = {}

    def put(self, key, t):
        t = t.detach()
        if key not in self.buf:
            self.buf[key] = torch.empty_like(t)
        self.buf[key].copy_(t)

    def snapshot(self) -> dict:
        return {k: v.clone() for k, v in self.buf.items()}

    def install(self, corpus, step, model):
        draw = corpus.draw

        def recorded_draw(idx, generator):
            out = draw(idx, generator)
            self.put("idx", idx)
            for j, t in enumerate(out):
                self.put(f"draw{j}", t)
            return out

        corpus.draw = recorded_draw

        def recorded_step(opt_state, batch, generator):
            self.put("clean", batch)
            return step(opt_state, batch, generator)

        def pre_hook(module, args):
            self.put("noisy", args[0])
            self.put("sigma", args[1])

        model.register_forward_pre_hook(pre_hook)
        return recorded_step


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    config = spec["config"]
    train, m = config["train"], config["model"]
    clips = config["corpus"]["kind"] == "video"
    stamp(t0, "imports")
    W = synth.weights(m, seed, device)
    model = program.build(config, W, device)
    opt_state, step = program.trainer(model, train, "3d" if clips else "2d")
    stamp(t0, "model and weights")
    corpus = make_corpus(config, seed, device)
    stamp(t0, "corpus")
    rec = Recorder()
    runner = program.epoch_runner(corpus, rec.install(corpus, step, model), model)
    gen = synth.generator(seed, "train", device)

    n_check = CHECK_STEPS
    if runner.steps < n_check:
        raise ValueError(f"an epoch of {runner.steps} steps holds no {n_check} checked steps")
    if runner.graphed:
        runner.capture(opt_state, gen)
        stamp(t0, "capture")
    runner.begin(gen)
    steps_rec, losses_prog, mu1 = [], [], None
    for i in range(n_check):
        runner.advance(opt_state, gen)
        steps_rec.append(rec.snapshot())
        losses_prog.append(float(runner.losses[i]))
        if i == 0:
            mu1 = {k: v.clone() for k, v in opt_state["mu"].items()}
    p_after = {k: v.detach().clone() for k, v in model.named_parameters()}
    for _ in range(runner.steps - n_check):
        runner.advance(opt_state, gen)
    float(runner.losses[-1])  # the epoch's losses read: set-up ends
    stamp(t0, "first epoch")

    spatial = ((train["depth"],) if clips else ()) + (train["crop"], train["crop"])
    step_flops = train["batch"] * work.train_sample_flops(m, spatial)
    step_roof = work.roofline_s(step_flops, work.train_step_bytes(m, spatial, train["batch"]))
    live = [*model.parameters(), *model.buffers(), opt_state["count"],
            *opt_state["mu"].values(), *opt_state["nu"].values()]
    with torch.no_grad():
        start = [t.detach().clone() for t in live]
    launches0 = program.launches()
    setup_s = time.perf_counter() - t0
    steps, failed = 0, 0
    with Trace(trace) as tr:
        w0_ns, w0 = time.time_ns(), time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            with torch.no_grad():
                for t, s in zip(live, start):
                    t.copy_(s)
            losses = runner(opt_state, gen).cpu()
            steps += losses.numel()
            failed += int((~torch.isfinite(losses)).sum())
        window_s = time.perf_counter() - w0
        w1_ns = time.time_ns()
    summary = tr.summary(w0_ns, w1_ns)
    launches = program.launches() - launches0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del runner, corpus, model, opt_state, step, rec, live, start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    crop_err, bad_draws = check_batches(config, seed, steps_rec, device)
    noise_err = check_noise(steps_rec, train["noise_std"])
    c1 = program.adam_c1()
    g_prog = {k: v / c1 for k, v in mu1.items()}
    readings = compare(m, train, W, steps_rec, losses_prog, g_prog, p_after)
    readings.update(crop_err=crop_err, bad_draws=bad_draws, noise_err=noise_err)
    return {
        "checked": {"W": W, "steps": steps_rec},
        "kind": "train", "attempted": steps, "failed": failed, "setup_s": setup_s,
        "window_s": window_s, "steps": steps, "samples": steps * train["batch"],
        "flops": steps * step_flops, "roofline_s": steps * step_roof, "launches": launches,
        "memory_peak_bytes": peak, "trace": summary, "readings": readings,
    }


def reference_run(m: dict, train: dict, W: dict, steps_rec: list, exact: bool = True) -> dict:
    """The reference's CHECK_STEPS steps on the recorded batches; exact
    False computes in TF32 (the control)."""
    batches = [(r["noisy"], r["sigma"].reshape(-1), r["clean"]) for r in steps_rec]
    with exact_fp32(exact):
        return train_steps(W, batches, m["s"], train["lr"], train["clip_grad"],
                           tf32=not exact)


def leaf_gaps(got: dict, ref: dict, keep) -> float:
    """The worst leaf's |norm(got) - norm(ref)| over the larger of
    norm(ref) and the median leaf's norm, over the leaves in keep."""
    norms = {k: float(ref[k].norm()) for k in ref}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(float(got[k].norm()) - norms[k]) / max(norms[k], med) for k in keep)


def compare(m, train, W, steps_rec, losses_prog, g_prog, p_after, ref=None) -> dict:
    """loss_gap: the worst step's |loss - reference| / reference;
    loss_gap_1: the first step's alone (a cell's limits file says which it
    compares: after Adam's first moves, each about lr times a gradient's
    sign, round-off moves the later losses by more at a larger lr);
    grad_gap: the first clipped gradient (the program's: its first moment
    after one step over 1 - b1) by leaf_gaps; change_gap: each leaf's
    change over the steps, by leaf_gaps. Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of both."""
    ref = ref or reference_run(m, train, W, steps_rec)
    norms = {k: float(v.norm()) for k, v in ref["grad0"].items()}
    med = sorted(norms.values())[len(norms) // 2]
    keep = [k for k in norms if norms[k] >= 1e-3 * med]
    gaps = [abs(a - b) / b for a, b in zip(losses_prog, ref["losses"])]
    change_prog = {k: p_after[k] - W[k] for k in keep}
    change_ref = {k: ref["params"][k] - W[k] for k in ref["params"]}
    return {"loss_gap": max(gaps), "loss_gap_1": gaps[0],
            "grad_gap": leaf_gaps(g_prog, ref["grad0"], keep),
            "change_gap": leaf_gaps(change_prog, change_ref, keep)}


def check_batches(config: dict, seed: int, steps_rec: list, device) -> tuple:
    """(max |clean batch - the reference's crops of the recorded draws|,
    the number of draws out of range or rows repeated across the steps)."""
    c, train = config["corpus"], config["train"]
    err, bad, seen = 0.0, 0, set()
    for r in steps_rec:
        idx = r["idx"].tolist()
        bad += len(set(idx) & seen) + len(idx) - len(set(idx))
        seen |= set(idx)
        draws = [r[f"draw{j}"].cpu() for j in range(len([k for k in r if k.startswith("draw")]))]
        for b, i in enumerate(idx):
            d = [x[b] for x in draws]
            if c["kind"] == "image":
                oh, ow, fh, fv = (int(v) for v in d)
                img = _image(config, seed, i, device)
                portrait = synth.portrait(c.get("portrait_share"), i)
                size = tuple(img.shape[-2:])[::-1] if portrait else tuple(img.shape[-2:])
                problems = ref_corpus.check_image_draws([0], [oh], [ow], [size], train["crop"])
                crop = ref_corpus.image_crop(img, train["crop"], portrait, oh, ow, bool(fh),
                                             bool(fv))
            else:
                video = _video(config, seed, i, device)
                walk, start_w, x0, y0, st, start_c, rev, do_crop, cx, cy = d
                args = (bool(walk), int(start_w), int(x0), int(y0), st.to(device),
                        int(start_c), bool(rev), bool(do_crop), int(cx), int(cy))
                problems = ref_corpus.check_clip_draws(
                    video.shape[1], train["depth"], video.shape[2:], (train["crop"],) * 2,
                    train["max_shift"], *args)
                crop = ref_corpus.clip_frames(video, train["depth"], (train["crop"],) * 2,
                                              train["max_shift"], *args)
            bad += len(problems)
            if crop.shape != r["clean"][b].shape:
                bad += 1
                continue
            err = max(err, float((crop - r["clean"][b]).abs().max()))
    return err, bad


def check_noise(steps_rec: list, noise_std) -> float:
    """The noise of each sample over its level, z, should be N(0, 1): the
    worst sample's |mean(z)| or |std(z) - 1| in standard errors of each
    (1 / sqrt(n), 1 / sqrt(2n) for n values), or inf where a level lies
    outside noise_std."""
    lo, hi = noise_std
    worst = 0.0
    for r in steps_rec:
        sigma = r["sigma"].reshape(-1)
        if bool(((sigma < lo) | (sigma > hi)).any()):
            return math.inf
        z = (r["noisy"] - r["clean"]).flatten(1).double() * 255.0 / sigma.view(-1, 1)
        n = z.shape[1]
        worst = max(worst, float(z.mean(1).abs().max()) * n ** 0.5,
                    float((z.std(1) - 1).abs().max()) * (2 * n) ** 0.5)
    return worst
