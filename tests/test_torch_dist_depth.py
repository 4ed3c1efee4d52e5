"""Depth (frame) sharding of the port's CDLNetVideo on gloo ranks on the
CPU: the point-to-point halo exchange and its adjoint, the plain halo
route (cdlnet_tpu_torch/dist/halo.py) against the JAX package's unsharded
apply, the kernel route (dist/halo_fused.py, on the kernels' plain
versions here) and its gradients against the port's unsharded forward and
gradients, and make_train_step, fit and Denoiser on depth and data x depth
meshes. Mirrors tests/test_dist.py's depth cases and
tests/test_dist_depth_fused.py.

As tests/test_torch_dist.py, this file re-runs itself as
`python tests/test_torch_dist_depth.py <leg> <outdir>`, one gloo process a
rank at one torch thread; only the pytest side imports jax.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
# (s, P, residual) of tests/test_dist.py::test_depth_sharded_forward_parity
HALO_CASES = [(1, (3, 3, 3), False), (2, (7, 7, 5), False), (1, (3, 3, 3), True)]
# the kernel route's cases: (P, s, D) on two ranks
FUSED_CASES = [((3, 3, 3), 2, 8), ((7, 7, 5), 2, 16)]
CFG = {"K": 4, "M": 8, "P": (5, 5, 3), "s": 2, "C": 1, "adaptive": True, "depth": 16}


def _rank_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(leg, n, out):
    from cdlnet_tpu_torch.dist.launch import launch_local

    rcs, outs = launch_local([sys.executable, THIS, leg, str(out)], n, env=_rank_env(),
                             timeout=300)
    assert rcs == [0] * n, "\n".join(outs)
    return [torch.load(os.path.join(str(out), f"{leg}_{r}.pt"), weights_only=False)
            for r in range(n)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- the legs ---

def _video(P, s, K=3, M=4, seed=0, backend="pallas", **kw):
    """A CDLNetVideo with power-method banks and small positive
    thresholds."""
    from cdlnet_tpu_torch.models import CDLNetVideo

    m = CDLNetVideo(K=K, M=M, P=P, s=s, adaptive=True, backend=backend, **kw)
    m.init(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.t.copy_(torch.rand(m.t.shape, generator=torch.Generator().manual_seed(seed + 1)) * 0.05)
    return m


def _rand(*shape, seed=0):
    return torch.rand(*shape, generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _halo_cases(mesh, out, key):
    """The plain halo route on the JAX package's parameters and clips."""
    from cdlnet_tpu_torch.compat.jax_params import load_jax_params
    from cdlnet_tpu_torch.dist import sharded_lista_3d_forward
    from cdlnet_tpu_torch.models import CDLNetVideo

    res = {}
    inp = np.load(os.path.join(out, f"{key}.npz"))
    for i, (s, P, residual) in enumerate(_CASES[key]):
        m = CDLNetVideo(K=3, M=6, P=P, s=s, adaptive=True, residual=residual)
        flat = {k.split("/", 1)[1]: inp[k] for k in inp.files if k.startswith(f"{i}/")}
        params = {k: v for k, v in flat.items() if "." not in k}
        if residual:
            params["residual"] = {k.split(".")[1]: v for k, v in flat.items() if "." in k}
        load_jax_params(m, params)
        with torch.no_grad():
            res[(s, P, residual)] = sharded_lista_3d_forward(
                m, torch.from_numpy(inp[f"y{i}"]), 25.0, mesh=mesh)
    return res


_CASES = {"halo2": HALO_CASES, "halo4": [(2, (7, 7, 5), False)]}


def _fused_case(mesh, P, s, D, batch_axis=None, N=2):
    """The kernel route against the unsharded kernel forward and
    gradients (dA, dB, dt) and the plain loop's dy."""
    from cdlnet_tpu_torch.dist import sharded_fused_3d_train_forward, sharded_lista_3d_fused_forward
    from cdlnet_tpu_torch.kernels.autodiff import lista3d_fused_diff
    from cdlnet_tpu_torch.kernels.lista3d import lista3d_fused
    from cdlnet_tpu_torch.ops.conv import conv_transpose3d
    from cdlnet_tpu_torch.ops.lista import lista_3d

    m = _video(P, s)
    y = _rand(N, 1, D, 16, 16, seed=2)
    ypc = y - y.mean(dim=(1, 2, 3, 4), keepdim=True)
    sig = torch.tensor([20.0, 30.0][:N]).reshape(N, 1, 1, 1, 1)
    with torch.no_grad():
        xs, zs = sharded_lista_3d_fused_forward(m, ypc, sig, mesh=mesh, batch_axis=batch_axis,
                                                return_z=True)
        xr, zr = lista3d_fused(ypc, m.A, m.B, m.t, sig / 255, stride=s)
    out = {"fwd": (_rel(xs, xr), _rel(zs, zr), bool(torch.equal(xs, xr)))}
    x0 = _rand(N, 1, D, 16, 16, seed=3)
    yy = ypc.clone().requires_grad_(True)
    loss = torch.mean((sharded_fused_3d_train_forward(m, yy, sig, mesh=mesh,
                                                      batch_axis=batch_axis) - x0) ** 2)
    got = torch.autograd.grad(loss, [m.A, m.B, m.t, yy])
    ref = torch.autograd.grad(torch.mean((lista3d_fused_diff(ypc, m.A, m.B, m.t, sig / 255,
                                                             stride=s) - x0) ** 2),
                              [m.A, m.B, m.t])
    yy2 = ypc.clone().requires_grad_(True)
    z = lista_3d(yy2, m.A, m.B, m.t, sig / 255, stride=s)
    xp = conv_transpose3d(z, m.B[0], stride=s, padding=m.pad, output_padding=s - 1)
    (dy,) = torch.autograd.grad(torch.mean((xp - x0) ** 2), [yy2])
    out["grads"] = [_rel(a, b) for a, b in zip(got, (*ref, dy))]
    out["grads_tensors"] = [g.clone() for g in got]
    return out


def _step(model, mesh, batch, seed=7):
    from cdlnet_tpu_torch.train.fit import make_train_step
    from cdlnet_tpu_torch.train.optim import make_optimizer

    opt = make_optimizer(1e-3, clip_grad=1.0)
    step, eval_step = make_train_step(model, opt, workload="3d", noise_std=(20, 30), mesh=mesh)
    loss = step(opt.init(dict(model.named_parameters())), batch,
                torch.Generator().manual_seed(seed))
    return float(loss), {k: v.detach().clone() for k, v in model.named_parameters()}, eval_step


def leg_depth2(out):
    """Two ranks on {"depth": 2}."""
    import torch.distributed as dist

    from cdlnet_tpu_torch.dist import (
        fused_depth_shard_supported,
        halo_exchange,
        make_mesh,
        sharded_lista_3d_forward,
        sharded_lista_3d_fused_forward,
    )
    from cdlnet_tpu_torch.serve import Denoiser
    from cdlnet_tpu_torch.train.fit import fit
    from cdlnet_tpu_torch.train.optim import make_optimizer

    mesh = make_mesh({"depth": 2})
    rank = dist.get_rank()
    res = {"rank": rank}
    # the exchange: a 3-frame halo below a 2-frame block reaches two ranks
    x = (torch.arange(2.0) + 10 * rank).reshape(1, 1, 2, 1, 1).requires_grad_(True)
    w = halo_exchange(x, 3, 1, mesh.group("depth"))
    (w * torch.arange(6.0).reshape(1, 1, 6, 1, 1)).sum().backward()
    res["halo"] = (w.detach().flatten().tolist(), x.grad.flatten().tolist())

    res["halo_route"] = _halo_cases(mesh, out, "halo2")
    for P, s, D in FUSED_CASES:
        res[("fused", P, s, D)] = _fused_case(mesh, P, s, D)

    for name, fn in (("bad_halo", sharded_lista_3d_forward),
                     ("bad_fused", sharded_lista_3d_fused_forward)):
        try:
            fn(_video((3, 3, 3), 2), torch.zeros(1, 1, 10, 16, 16), 25.0, mesh=mesh)
            res[name] = None
        except ValueError as e:
            res[name] = str(e)
    res["gate"] = fused_depth_shard_supported(_video((5, 5, 3), 2), 16, 32, 48, 2)

    # make_train_step on a depth mesh against the meshless step
    batch = _rand(2, 1, 16, 16, 24, seed=1)
    for name, mesh_arg in (("step", mesh), ("step_ref", None)):
        m = _video(CFG["P"], 2, K=CFG["K"], M=CFG["M"])
        loss, params, eval_step = _step(m, mesh_arg, batch)
        res[name] = (loss, params)
        res[name + "_eval"] = float(eval_step(batch, torch.Generator().manual_seed(8)))
        res[name + "_ragged"] = _step(m, mesh_arg, _rand(2, 1, 12, 16, 24, seed=3))[0]
    for name, mesh_arg in (("res_step", mesh), ("res_step_ref", None)):
        m = _video((3, 3, 3), 1, K=2, M=4, residual=True)
        res[name] = _step(m, mesh_arg, _rand(1, 1, 8, 16, 16, seed=4))[:2]

    m = _video(CFG["P"], 2, K=CFG["K"], M=CFG["M"])
    clips = [np.random.default_rng(0).uniform(0, 1, (2, 1, 16, 16, 16)).astype(np.float32)]
    opt = make_optimizer(1e-3, clip_grad=1.0)
    save = os.path.join(out, f"fit{rank}")
    _, hist = fit(m, opt, opt.init(dict(m.named_parameters())),
                  {"train": clips * 2, "val": clips, "test": clips}, save_dir=save, epochs=1,
                  workload="3d", noise_std=(20, 30), mesh={"depth": 2},
                  backtrack_thresh=None, verbose=False)
    res["fit"] = (hist, os.path.exists(os.path.join(save, "train.txt")))

    # mesh serving on a depth mesh against the meshless Denoiser
    clip = np.random.default_rng(3).uniform(0, 1, (1, 1, 16, 32, 48)).astype(np.float32)
    for name, model in (("serve", _video(CFG["P"], 2, K=CFG["K"], M=CFG["M"])),
                        ("serve_residual", _video((3, 3, 3), 2, K=2, M=4, residual=True))):
        res[name] = (Denoiser(model, bucket=16, mesh={"depth": 2}).denoise_video(clip, sigma=25),
                     Denoiser(model, bucket=16).denoise_video(clip, sigma=25))
    model = _video(CFG["P"], 2, K=CFG["K"], M=CFG["M"])
    res["serve_ragged"] = (
        Denoiser(model, bucket=16, mesh={"depth": 2}).denoise_video(clip[:, :, :6], sigma=25),
        Denoiser(model, bucket=16).denoise_video(clip[:, :, :6], sigma=25))
    return res


def leg_depth4(out):
    """Four ranks: {"depth": 4} (multi-hop halos) and {"data": 2, "depth":
    2}."""
    import torch.distributed as dist

    from cdlnet_tpu_torch.dist import make_mesh

    res = {"rank": dist.get_rank()}
    mesh = make_mesh({"depth": 4})
    res["halo_route"] = _halo_cases(mesh, out, "halo4")
    res["fused"] = _fused_case(mesh, (5, 5, 3), 2, 16)
    dd = make_mesh({"data": 2, "depth": 2})
    res["fused_dd"] = _fused_case(dd, (5, 5, 3), 2, 16, batch_axis="data")
    batch = _rand(2, 1, 16, 16, 24, seed=1)
    for name, mesh_arg in (("step", dd), ("step_ref", None)):
        res[name] = _step(_video(CFG["P"], 2, K=CFG["K"], M=CFG["M"]), mesh_arg, batch)[:2]
    return res


LEGS = {"depth2": leg_depth2, "depth4": leg_depth4}


# -------------------------------------------------------------- fixtures ---

def _jax_halo_inputs(out, key, D):
    """Spectrally normalized banks (the port's power-method init), the
    clips, and the JAX package's unsharded apply on them, for the plain
    halo route's cases."""
    import jax.numpy as jnp

    from cdlnet_tpu.models import CDLNetVideo
    from cdlnet_tpu_torch.compat.jax_params import export_jax_params

    arrays, refs = {}, {}
    for i, (s, P, residual) in enumerate(_CASES[key]):
        params = export_jax_params(_video(P, s, M=6, backend="xla", residual=residual))
        y = np.random.default_rng(3).random((1, 1, D, 16, 16)).astype(np.float32)
        model = CDLNetVideo(K=3, M=6, P=P, s=s, adaptive=True, residual=residual)
        xhat, z = model.apply(params, jnp.asarray(y), 25.0)
        refs[(s, P, residual)] = (np.asarray(xhat), np.asarray(z))
        arrays[f"y{i}"] = y
        for k, v in params.items():
            if isinstance(v, dict):
                arrays.update({f"{i}/{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
            else:
                arrays[f"{i}/{k}"] = np.asarray(v)
    np.savez(os.path.join(str(out), f"{key}.npz"), **arrays)
    return refs


@pytest.fixture(scope="module")
def depth2(tmp_path_factory):
    out = tmp_path_factory.mktemp("depth2")
    refs = _jax_halo_inputs(out, "halo2", 16)
    return run_ranks("depth2", 2, out), refs


@pytest.fixture(scope="module")
def depth4(tmp_path_factory):
    out = tmp_path_factory.mktemp("depth4")
    refs = _jax_halo_inputs(out, "halo4", 8)
    return run_ranks("depth4", 4, out), refs


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# ----------------------------------------------------------------- tests ---

def test_gate():
    from cdlnet_tpu_torch.dist import fused_depth_shard_supported
    from cdlnet_tpu_torch.models.base import build_model

    m = build_model("CDLNetVideo", {**CFG, "backend": "pallas"})
    assert fused_depth_shard_supported(m, 16, 32, 48, 4)
    assert fused_depth_shard_supported(m, 16, 32, 48, 4, train=True)
    # backend "xla", one shard, an indivisible depth, residual blocks, a mask
    assert not fused_depth_shard_supported(build_model("CDLNetVideo", CFG), 16, 32, 48, 4)
    assert not fused_depth_shard_supported(m, 16, 32, 48, 1)
    assert not fused_depth_shard_supported(m, 12, 32, 48, 8)
    assert not fused_depth_shard_supported(m, 16, 32, 48, 4, mask=torch.ones(1))
    mres = build_model("CDLNetVideo", {**CFG, "residual": True, "backend": "pallas"})
    assert not fused_depth_shard_supported(mres, 16, 32, 48, 4)
    # P=(7,7,5), s=2: hz = 3 code frames; a kept frame's cone must stay
    # inside the other ranks' (n - 1) * Dzl real code frames
    m7 = build_model("CDLNetVideo", {**CFG, "P": (7, 7, 5), "backend": "pallas"})
    assert fused_depth_shard_supported(m7, 16, 32, 48, 2)
    assert fused_depth_shard_supported(m7, 8, 32, 48, 4)
    assert not fused_depth_shard_supported(m7, 4, 32, 48, 2)


def test_single_process_depth_mesh_is_the_unsharded_forward():
    """The trivial mesh (one process, no group): the plain route is the
    plain forward, bitwise."""
    from cdlnet_tpu_torch.dist import make_mesh, sharded_lista_3d_forward

    m = _video((3, 3, 3), 2, backend="xla")
    y = _rand(1, 1, 8, 16, 16)
    with torch.no_grad():
        xs, zs = sharded_lista_3d_forward(m, y, 25.0, mesh=make_mesh({"depth": 1}))
        xr, zr = m(y, 25.0, return_z=True)
    assert torch.equal(xs, xr) and torch.equal(zs, zr)


def test_single_process_kernel_route_is_the_unsharded_kernels():
    """On one rank the kernel route's window is the whole clip and zeros
    past it: its forward and gradients are the unsharded kernels' (which
    have no dy; its dy is the plain loop's). chip_smoke.py's D2 holds the
    sharded dy to this one-rank route on the card."""
    from cdlnet_tpu_torch.dist.mesh import Mesh

    out = _fused_case(Mesh({"depth": 1}), (7, 7, 5), 2, 8)
    dx, dz, _ = out["fwd"]
    assert dx <= 1e-6 and dz <= 1e-6, (dx, dz)
    assert max(out["grads"]) <= 1e-5, out["grads"]


def test_halo_exchange_multi_hop_and_its_adjoint(depth2):
    ranks, _ = depth2
    # rank 0 holds frames 0, 1 (values 0, 1); rank 1 frames 2, 3 (10, 11)
    assert ranks[0]["halo"][0] == [0.0, 0.0, 0.0, 0.0, 1.0, 10.0]
    assert ranks[1]["halo"][0] == [0.0, 0.0, 1.0, 10.0, 11.0, 0.0]
    # each frame's gradient: its weights in every window that took it
    assert ranks[0]["halo"][1] == [3.0 + 1.0, 4.0 + 2.0]
    assert ranks[1]["halo"][1] == [3.0 + 5.0, 4.0]


@pytest.mark.parametrize("case", HALO_CASES, ids=str)
def test_depth_halo_route_matches_jax_unsharded(depth2, case):
    ranks, refs = depth2
    xr, zr = refs[case]
    for r in ranks:
        xs, zs = r["halo_route"][case]
        _close(xs, xr, rtol=0, atol=1e-5)
        _close(zs, zr, rtol=0, atol=1e-5)
    assert torch.equal(ranks[0]["halo_route"][case][0], ranks[1]["halo_route"][case][0])


def test_depth_halo_route_four_ranks_multi_hop_matches_jax(depth4):
    ranks, refs = depth4
    case = (2, (7, 7, 5), False)
    xr, zr = refs[case]
    for r in ranks:
        xs, zs = r["halo_route"][case]
        _close(xs, xr, rtol=0, atol=1e-5)
        _close(zs, zr, rtol=0, atol=1e-5)


def test_depth_sharded_rejects_bad_depth(depth2):
    ranks, _ = depth2
    for r in ranks:
        assert r["bad_halo"] == "depth 10 must divide mesh depth axis 2 x stride 2"
        assert r["bad_fused"] == "depth 10 must divide depth axis 2 x stride 2"
        assert r["gate"]


@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_kernel_route_forward_matches_unsharded(depth2, case):
    ranks, _ = depth2
    for r in ranks:
        dx, dz, _ = r[("fused", *case)]["fwd"]
        assert dx <= 1e-5 and dz <= 1e-5, (dx, dz)


@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_kernel_route_gradients_match_unsharded(depth2, case):
    ranks, _ = depth2
    for r in ranks:
        errs = r[("fused", *case)]["grads"]
        assert max(errs) <= 1e-4, dict(zip(("dA", "dB", "dt", "dy"), errs))
    for a, b in zip(ranks[0][("fused", *case)]["grads_tensors"],
                    ranks[1][("fused", *case)]["grads_tensors"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("key", ["fused", "fused_dd"])
def test_kernel_route_four_ranks(depth4, key):
    ranks, _ = depth4
    for r in ranks:
        dx, dz, _ = r[key]["fwd"]
        assert dx <= 1e-5 and dz <= 1e-5, (dx, dz)
        assert max(r[key]["grads"]) <= 1e-4, r[key]["grads"]


def test_make_train_step_depth_mesh_matches_meshless(depth2):
    ranks, _ = depth2
    for r in ranks:
        loss, params = r["step"]
        loss_ref, params_ref = r["step_ref"]
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
        for k in ("A", "B"):
            _close(params[k], params_ref[k], rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(r["step_eval"], r["step_ref_eval"], rtol=1e-6)
        # a ragged clip depth runs unsharded on every rank
        np.testing.assert_allclose(r["step_ragged"], r["step_ref_ragged"], rtol=1e-6)


def test_make_train_step_depth_mesh_residual_takes_the_halo_route(depth2):
    ranks, _ = depth2
    for r in ranks:
        loss, params = r["res_step"]
        loss_ref, params_ref = r["res_step_ref"]
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
        for k in params:
            _close(params[k], params_ref[k], rtol=1e-4, atol=1e-6)


def test_make_train_step_data_by_depth_mesh(depth4):
    ranks, _ = depth4
    for r in ranks:
        loss, params = r["step"]
        loss_ref, params_ref = r["step_ref"]
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
        for k in ("A", "B"):
            _close(params[k], params_ref[k], rtol=1e-4, atol=1e-7)
    for k in ranks[0]["step"][1]:
        assert all(torch.equal(ranks[0]["step"][1][k], r["step"][1][k]) for r in ranks)


def test_fit_accepts_depth_mesh(depth2):
    ranks, _ = depth2
    for r in ranks:
        hist, wrote = r["fit"]
        assert wrote and all(np.isfinite(p) for _, _, p in hist)
    assert ranks[0]["fit"][0] == ranks[1]["fit"][0]


@pytest.mark.parametrize("key", ["serve", "serve_residual", "serve_ragged"])
def test_denoiser_depth_mesh_matches_meshless(depth2, key):
    ranks, _ = depth2
    for r in ranks:
        got, ref = r[key]
        assert got.shape == ref.shape
        _close(got, ref, rtol=0, atol=1e-5)


if __name__ == "__main__":
    leg, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from cdlnet_tpu_torch.dist.init import initialize_distributed, shutdown_distributed

    initialize_distributed(device="cpu")
    result = LEGS[leg](out)
    torch.save(result, os.path.join(out, f"{leg}_{dist.get_rank()}.pt"))
    shutdown_distributed()
