"""cdlnet_tpu_torch's frame-recurrent CSR training on the CPU against the JAX
package: the CSR prox adjoints' plain versions against torch autograd of
the proxes, csr_fused_2d_train (the kernels' plain versions) against JAX's
csr_fused_2d_train with its Pallas kernels (K5 forward with u history, K6
reverse in its prox modes) in interpret mode, the frame-recurrent loss and
its gradients against JAX model.apply(train=True) calls in fit_csr's
order, remat against no remat, fit_csr, the fastMRI training loaders
against JAX's, and the train CLI's CSR and fastMRI (PDFS) branches.

Inputs and noise come from numpy seeds and go to both packages."""

import json
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cdlnet_tpu.data.fastmri import get_fastmri_fit_loaders as jax_get_fastmri_fit_loaders
from cdlnet_tpu.data.fastmri import volume_to_batch_loaders as jax_volume_to_batch_loaders
from cdlnet_tpu.kernels.autodiff import csr_fused_2d_train as jax_csr_fused_2d_train
from cdlnet_tpu.models import CDLNetCSR as JaxCDLNetCSR
from cdlnet_tpu.models import CDLNetCSRf2 as JaxCDLNetCSRf2
from cdlnet_tpu_torch.cli import train as cli_train
from cdlnet_tpu_torch.compat.jax_params import load_jax_params
from cdlnet_tpu_torch.core.ops import prox_csr, prox_csr_f2
from cdlnet_tpu_torch.data.fastmri import get_fastmri_fit_loaders, volume_to_batch_loaders
from cdlnet_tpu_torch.data.noise import awgn
from cdlnet_tpu_torch.data.synthetic import gen_synthetic_mri_dirs
from cdlnet_tpu_torch.kernels import lista2d_bwd as LB2
from cdlnet_tpu_torch.kernels.autodiff import csr_fused_2d_train
from cdlnet_tpu_torch.models import CDLNetCSR, CDLNetCSRf2
from cdlnet_tpu_torch.train.checkpoint import load_ckpt
from cdlnet_tpu_torch.train.fit_csr import fit_csr, make_csr_train_step
from cdlnet_tpu_torch.train.optim import make_optimizer

FAMILIES = {"CDLNet_CSR": (JaxCDLNetCSR, CDLNetCSR),
            "CDLNet_CSRf2": (JaxCDLNetCSRf2, CDLNetCSRf2)}
CFG = dict(K=3, M=8, P=5, s=2, C=1, adaptive=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- (1) the prox adjoints' plain versions against torch autograd ---

def _prox_operands(seed, two_sided):
    """Codes with exact zeros in u and the neighbours, u on the shift (or
    on Ca) and z_prev == z_after rows: the zeros and ties where sign() and
    the masks meet."""
    rng = np.random.default_rng(seed)
    shape = (2, 5, 6, 7)
    f = lambda: rng.standard_normal(shape).astype(np.float32)
    u, zp, za = f(), f(), f()
    zp = np.where(rng.uniform(size=shape) < 0.3, 0, zp).astype(np.float32)
    u[0, 0] = 0.0
    za[1, 1] = zp[1, 1]
    tau = (0.3 * np.abs(rng.standard_normal((2, 5, 1, 1)))).astype(np.float32)
    g1, g2 = (np.abs(rng.standard_normal((2, 5, 1, 1))).astype(np.float32) for _ in range(2))
    if two_sided:
        Ca = zp + tau * np.sign(zp) + tau * g2 * np.sign(zp - za)
        u[1, 2] = Ca[1, 2]
    else:
        u[1, 2] = zp[1, 2] + tau[1, 2] * np.sign(zp[1, 2])
    return [torch.from_numpy(a) for a in (u, zp, za, tau, g1, g2, f())]


@pytest.mark.parametrize("two_sided", [False, True], ids=["csr", "csrf2"])
def test_prox_adjoint_plain_matches_autograd(two_sided):
    u, zp, za, tau, g1, g2, dz = _prox_operands(7 + two_sided, two_sided)
    leaves = [x.clone().requires_grad_() for x in (u, zp, za, tau, g1, g2)]
    lu, lzp, lza, ltau, lg1, lg2 = leaves
    if two_sided:
        z = prox_csr_f2(lu, lzp, lza, ltau, lg1, lg2)
        wants = torch.autograd.grad(z, [lu, lzp, lza, ltau, lg1, lg2], dz)
        gots = LB2.prox_csr_f2_adjoint_plain(dz, z.detach(), u, zp, za, tau, g1, g2)
    else:
        z = prox_csr(lu, lzp, ltau, lg1)
        wants = torch.autograd.grad(z, [lu, lzp, ltau, lg1], dz)
        gots = LB2.prox_csr_adjoint_plain(dz, z.detach(), u, zp, tau, g1)
    for i, (got, want) in enumerate(zip(gots, wants)):
        if want.shape != got.shape:  # tau and gamma broadcast: sum the codes
            got = got.sum(dim=(2, 3), keepdim=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=str(i))


# --- (2) csr_fused_2d_train against JAX's, kernels in interpret mode ---

def _fused_inputs(seed=0):
    """K=3, M=8, P=7, s=2, N=2 at 32^2 with per-image sigma, positive
    thresholds and gamma banks, sparse neighbour codes, and cotangents of
    both outputs."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    K, M, N, H = 3, 8, 2, 32
    ops = dict(yp=0.3 * f(N, 1, H, H), A=0.1 * f(K, M, 1, 7, 7), B=0.1 * f(K, M, 1, 7, 7),
               t=0.02 * np.abs(f(K, 2, M, 1, 1)),
               c=np.array([20 / 255, 30 / 255], np.float32).reshape(N, 1, 1, 1))
    zp = f(N, M, H // 2, H // 2)
    codes = dict(z_prev=np.where(np.abs(zp) < 0.5, 0, zp).astype(np.float32),
                 z_after=0.3 * f(N, M, H // 2, H // 2),
                 g=0.5 * np.abs(f(K, 2, M, 1, 1)), g2=0.5 * np.abs(f(K, 2, M, 1, 1)))
    cot = (f(N, 1, H, H), f(N, M, H // 2, H // 2))
    return ops, codes, cot


MODES = {"st": (), "z_prev": ("g", "z_prev"), "z_after": ("g2", "z_after"),
         "both": ("g", "z_prev", "g2", "z_after")}


@pytest.mark.parametrize("mode", list(MODES))
def test_csr_fused_2d_train_matches_jax_interpret(mode, monkeypatch):
    """x, z and the gradients of A, B, t and of each gamma bank and
    neighbour code the mode takes, the returned code's cotangent seeding
    the reverse in every mode (the soft-threshold one too), within 1e-4 of
    JAX's fused kernels (fp32 histories)."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    ops, codes, (dx, dz) = _fused_inputs()
    names = ("A", "B", "t") + MODES[mode]
    diff = {k: ops[k] for k in ("A", "B", "t")} | {k: codes[k] for k in MODES[mode]}

    def jf(*vals):
        kw = dict(zip(names, vals))
        return jax_csr_fused_2d_train(jnp.asarray(ops["yp"]), kw.pop("A"), kw.pop("B"),
                                      kw.pop("t"), jnp.asarray(ops["c"]), stride=2,
                                      interpret=True, **kw)

    (xj, zj), vjp = jax.vjp(jf, *(jnp.asarray(diff[n]) for n in names))
    gj = vjp((jnp.asarray(dx), jnp.asarray(dz)))
    leaves = {n: torch.from_numpy(diff[n]).requires_grad_() for n in names}
    kw = {n: leaves[n] for n in MODES[mode]}
    xt, zt = csr_fused_2d_train(torch.from_numpy(ops["yp"]), leaves["A"], leaves["B"],
                                leaves["t"], torch.from_numpy(ops["c"]), stride=2, **kw)
    gt = torch.autograd.grad([xt, zt], [leaves[n] for n in names],
                             [torch.from_numpy(dx), torch.from_numpy(dz)])
    assert _rel(xt.detach(), xj) <= 1e-4 and _rel(zt.detach(), zj) <= 1e-4
    for n, a, b in zip(names, gt, gj):
        assert _rel(a, b) <= 1e-4, (n, _rel(a, b))


# --- (3) the frame-recurrent loss and its gradients against JAX ---

def _params(family, seed=0):
    """JAX-initialized params with seeded positive thresholds and gamma
    banks; CDLNetCSR's first-frame banks set to the primary ones (the
    reference's default A2/B2 init is expansive)."""
    jm = FAMILIES[family][0](**CFG)
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name, v in p.items():
        if v.shape[1] == 2:  # t, t2, g, g1, g2
            scale = 0.05 if name.startswith("t") else 0.5
            p[name] = (scale * rng.uniform(size=v.shape)).astype(np.float32)
    if family == "CDLNet_CSR":
        p["A2"], p["B2"] = p["A"].copy(), p["B"].copy()
    return jm, p


def _port(family, params, backend):
    return load_jax_params(FAMILIES[family][1](**CFG, backend=backend), params)


class _Recorder:
    """An optimizer stand-in that keeps the gradients train_step hands it."""

    def update(self, params, grads, state):
        state.update({n: g.clone() for n, g in grads.items()})


def _volumes(seed, shape=(2, 1, 3, 32, 32)):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.2, 0.8, shape).astype(np.float32))


def _port_codes(model, family, hats, sigmas):
    """The codes the port's recurrence carries from apply to apply, in
    fit_csr's order, without gradients."""
    (prev_hat, curr_hat, after_hat), (s1, s2, s3) = hats, sigmas
    with torch.no_grad():
        if family == "CDLNet_CSR":
            _, z1 = model(prev_hat, None, s1)
            _, z2 = model(curr_hat, z1, s2)
            _, z3 = model(prev_hat, z2, s1)
            return [z.numpy() for z in (z1, z2, z3)]
        _, z_prev = model(prev_hat, None, None, s1)
        _, z_after = model(after_hat, z_prev, None, s3)
        return [z.numpy() for z in (z_prev, z_after)]


def _jax_loss(jm, family, frames, hats, sigmas, codes):
    """fit_csr.loss_fn's composition of JAX model.apply(train=True) calls
    (cdlnet_tpu/train/fit_csr.py:74-101) on given noisy frames. Each
    carried code takes the port's value while its gradient flows through
    JAX's: pin(z, i) = codes[i] + (z - stop_gradient(z))."""
    (prev, curr, after), (prev_hat, curr_hat, after_hat), (s1, s2, s3) = frames, hats, sigmas
    pin = lambda z, i: jnp.asarray(codes[i]) + (z - jax.lax.stop_gradient(z))

    def loss(p):
        ap = lambda *a: jm.apply(p, *a, train=True)
        if family == "CDLNet_CSR":
            _, z_prev = ap(prev_hat, None, s1)
            _, z_curr = ap(curr_hat, pin(z_prev, 0), s2)
            prev_d, z_prev = ap(prev_hat, pin(z_curr, 1), s1)
            curr_d, _ = ap(curr_hat, pin(z_prev, 2), s2)
            return jnp.mean((prev_d - prev) ** 2) + jnp.mean((curr_d - curr) ** 2)
        _, z_prev = ap(prev_hat, None, None, s1)
        z_prev = pin(z_prev, 0)
        after_d, z_after = ap(after_hat, z_prev, None, s3)
        z_after = pin(z_after, 1)
        curr_d, _ = ap(curr_hat, z_prev, z_after, s2)
        prev_d, _ = ap(prev_hat, None, z_after, s1)
        return (jnp.mean((prev_d - prev) ** 2) + jnp.mean((curr_d - curr) ** 2)
                + jnp.mean((after_d - after) ** 2))

    return loss


@pytest.mark.parametrize("backend", ["cuda", "xla"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_csr_train_step_loss_and_grads_match_jax(family, backend, monkeypatch):
    """make_csr_train_step's loss and every parameter's gradient against
    jax.value_and_grad of JAX model.apply(train=True) calls composed in
    fit_csr.loss_fn's order, on the same noisy frames (drawn here as the
    step draws them: prev, curr, then after, from one generator), the
    carried codes at the port's values.

    Why the codes are pinned: prox_csr toward z_prev returns
    ST(z_prev + tau sign(z_prev), tau), z_prev up to its last bit, wherever
    its inner threshold clips, so a carried z_after equals z_prev but for
    rounding, and the next two-sided prox reads sign(z_prev - z_after),
    which moves its jump point Ca by 2 tau gamma2. Two fp32 programs that
    sum in other orders differ there (at 32^2 here such codes flip, and
    the gradients move far past 1e-4), so the recurrence is held with each
    apply's code inputs equal. fp32 histories in both packages (the 1e-4
    gate is an fp32 one)."""
    monkeypatch.setenv("CDLNET_HIST_DTYPE", "f32")
    jm, params = _params(family)
    model = _port(family, params, backend)
    batch = _volumes(1)
    nstd = (20, 30)
    gen = torch.Generator().manual_seed(5)
    noisy = [awgn(batch[:, :, i], nstd, gen) for i in range(3)]
    rec = {}
    step, _ = make_csr_train_step(model, _Recorder(), noise_std=nstd, remat=False)
    codes = _port_codes(model, family, *zip(*noisy))
    loss = step(rec, batch, torch.Generator().manual_seed(5))
    frames = [jnp.asarray(batch[:, :, i].numpy()) for i in range(3)]
    hats = [jnp.asarray(y.numpy()) for y, _ in noisy]
    sigmas = [jnp.asarray(s.numpy()) for _, s in noisy]
    lj, gj = jax.value_and_grad(_jax_loss(jm, family, frames, hats, sigmas, codes))(
        jax.tree_util.tree_map(jnp.asarray, params))
    assert float(loss) == pytest.approx(float(lj), rel=1e-5)
    assert rec.keys() == gj.keys()
    for name in gj:
        assert _rel(rec[name], gj[name]) <= 1e-4, (name, _rel(rec[name], gj[name]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_csr_remat_grads_match(family):
    """remat=True (each apply recomputed in the backward) gives the loss and
    gradients of remat=False, bit for bit, on the kernels' path."""
    _, params = _params(family)
    model = _port(family, params, "cuda")
    batch = _volumes(2, (1, 1, 3, 32, 32))
    out = {}
    for remat in (False, True):
        rec = {}
        step, _ = make_csr_train_step(model, _Recorder(), noise_std=(20, 30), remat=remat)
        out[remat] = (step(rec, batch, torch.Generator().manual_seed(3)), rec)
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][1].items():
        assert torch.equal(out[True][1][name], g), name


# --- (4) fit_csr ---

def test_fit_csr_runs(tmp_path):
    """Two epochs on in-memory volumes: the phases, finite parameters, the
    artifacts fit() writes, the StepLR decay and a checkpoint that reloads."""
    model = CDLNetCSRf2(K=2, M=4, P=3, s=1, adaptive=True, backend="cuda")
    model.init(torch.Generator().manual_seed(0))
    opt = make_optimizer(1e-3, clip_grad=1.0)
    state = opt.init(dict(model.named_parameters()))
    vols = _volumes(4, (4, 1, 3, 16, 16)).numpy()
    loaders = {"train": [vols[:2], vols[2:]], "val": [vols[:1]], "test": [vols[1:2]]}
    state, history = fit_csr(model, opt, state, loaders, save_dir=str(tmp_path), epochs=2,
                             noise_std=(20, 30), val_freq=10, save_freq=1, verbose=False,
                             sched={"step_size": 1, "gamma": 0.5}, loss="mse")
    assert [(e, ph) for e, ph, _ in history] == [(1, "train"), (2, "train"), (2, "test")]
    assert all(np.isfinite(p) for _, _, p in history)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    for name in ("0.ckpt.npz", "net_epoch_1.ckpt.npz", "net_epoch_2.ckpt.npz",
                 "net.ckpt.npz", "train.txt", "test.txt", "metrics.jsonl"):
        assert (tmp_path / name).exists(), name
    assert re.fullmatch(r"(-?\d+\.\d{3}, ){2}", (tmp_path / "train.txt").read_text())
    rows = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in rows] == ["train", "train", "test"]
    assert state["count"] == 4 and rows[-1]["lr"] == pytest.approx(1e-3 * 0.5)
    back = CDLNetCSRf2(K=2, M=4, P=3, s=1, adaptive=True)
    _, _, epoch, lr = load_ckpt(str(tmp_path / "net_epoch_1.ckpt.npz"), back)
    assert epoch == 1 and lr == pytest.approx(1e-3 * 0.5)
    _, _, epoch, _ = load_ckpt(str(tmp_path / "net.ckpt.npz"), back)
    assert epoch == 2 and all(torch.equal(a, b) for a, b in
                              zip(back.parameters(), model.parameters()))


def test_fit_csr_names_the_fit_keys_it_ignores(tmp_path, capsys):
    """fit's keys that the CSR trainer has no use for (an args.json's
    backtrack_thresh, mcsure, demosaic) are taken and named, not applied."""
    model = CDLNetCSR(K=2, M=4, P=3, s=1, backend="cuda")
    model.init(torch.Generator().manual_seed(1))
    opt = make_optimizer(1e-3, clip_grad=1.0)
    state = opt.init(dict(model.named_parameters()))
    vols = _volumes(6, (1, 1, 2, 8, 8)).numpy()
    fit_csr(model, opt, state, {"train": [vols], "val": [], "test": [vols]},
            save_dir=str(tmp_path), epochs=1, verbose=False, backtrack_thresh=1,
            mcsure=False, demosaic=False)
    assert ("fit_csr: ignoring fit args ['backtrack_thresh', 'demosaic', 'mcsure']"
            in capsys.readouterr().out)


# --- (5) the fastMRI training loaders ---

@pytest.fixture(scope="module")
def mri_dirs(tmp_path_factory):
    """Three splits of three 5-slice 24^2 volumes, one of them not
    CORPD_FBK."""
    return gen_synthetic_mri_dirs(str(tmp_path_factory.mktemp("mri")), n_volumes=3,
                                  slices=5, size=24, seed=1)


def _fit_loader_args(mri_dirs, **kw):
    return dict({f"{k}_path_list": [os.path.join(mri_dirs, split)] for k, split in
                 (("trn", "train"), ("val", "val"), ("tst", "test"))},
                crop_size=16, depth=3, **kw)


@pytest.mark.parametrize("PDFS", [True, False])
def test_fastmri_fit_loaders_yield_the_jax_batches(mri_dirs, PDFS):
    """get_fastmri_fit_loaders gives JAX's batches at seed 0 over two
    epochs: random start slices, one shared 16^2 crop a volume, the train
    split shuffled with its last short batch dropped; val and test whole;
    and VolumeToBatchLoader puts the slices in the batch dim as JAX's."""
    kw = _fit_loader_args(mri_dirs, batch_size=[2, 1, 1], PDFS=PDFS, seed=0)
    port, ref = get_fastmri_fit_loaders(**kw), jax_get_fastmri_fit_loaders(**kw)
    assert len(port["train"]) == len(ref["train"]) == 1
    for _ in range(2):
        for split in ("train", "val", "test"):
            got, want = list(port[split]), [np.asarray(b) for b in ref[split]]
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert got[0].shape == (1, 1, 3, 24, 24)
    flat, jflat = volume_to_batch_loaders(port), jax_volume_to_batch_loaders(ref)
    for split in ("train", "test"):
        a, b = next(iter(flat[split])), np.asarray(next(iter(jflat[split])))
        assert a.shape == b.shape == ((6, 1, 16, 16) if split == "train" else (3, 1, 24, 24))
        np.testing.assert_array_equal(a, b)
        assert len(flat[split]) == len(port[split])


def test_fastmri_dataset_rejects_what_it_cannot_cut(mri_dirs):
    """Too few slices, or a crop bigger than the image, raise."""
    from cdlnet_tpu_torch.data.fastmri import FastMRIDataset

    root = [os.path.join(mri_dirs, "train")]
    with pytest.raises(ValueError, match="slices"):
        FastMRIDataset(root, depth=9)[0]
    with pytest.raises(ValueError, match="crop"):
        FastMRIDataset(root, depth=2, image_size=(32, 16))[0]


# --- (6) the train CLI's CSR and fastMRI branches ---

def _cli_args(mri_dirs, save, mtype, **model):
    return {"type": mtype,
            "model": dict(dict(K=2, M=6, P=5, s=2, C=1, adaptive=True, init=True), **model),
            "paths": {"save": save, "ckpt": None},
            "train": {"opt": {"lr": 1e-3},
                      "fit": {"epochs": 1, "noise_std": [20, 30], "val_freq": 1,
                              "save_freq": 1, "clip_grad": 0.05},
                      "loaders": _fit_loader_args(mri_dirs, batch_size=[2, 1, 1],
                                                  PDFS=True, num_workers=2),
                      "sched": {"step_size": 1, "gamma": 0.5}}}


@pytest.mark.parametrize("mtype,model,backend", [
    ("CDLNet_CSR", {}, "cuda"), ("CDLNet_CSRf2", {}, "pallas"),
    ("CDLNetVideo", {"P": [5, 5, 3]}, "pallas"), ("CDLNet", {}, "pallas"),
])
def test_cli_trains_on_fastmri_volumes(mri_dirs, tmp_path, mtype, model, backend):
    """cli.train.main on fastMRI volumes with device="cpu": the CSR models
    through fit_csr, CDLNetVideo as workload "mri" and CDLNet on the
    volumes' slices, one epoch each, with args.json saved for a resume."""
    args = _cli_args(mri_dirs, str(tmp_path), mtype, backend=backend, **model)
    _, history = cli_train.main(args, device="cpu")
    assert [ph for _, ph, _ in history] == ["train", "val", "test"]
    assert all(np.isfinite(p) for _, _, p in history)
    assert (tmp_path / "net.ckpt.npz").exists()
    saved = json.loads((tmp_path / "args.json").read_text())
    assert saved["paths"]["ckpt"] == os.path.join(str(tmp_path), "net.ckpt.npz")
    if mtype.startswith("CDLNet_CSR"):
        assert (tmp_path / "net_epoch_1.ckpt.npz").exists()
