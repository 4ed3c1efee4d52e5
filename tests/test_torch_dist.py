"""The port's distributed layer (cdlnet_tpu_torch/dist/) on gloo ranks on
the CPU: mesh specs, the sigma rules of the data-parallel forward, two-rank
data parallelism against the JAX package's unsharded steps, subband TP and
DP x TP against the replicated step, mesh training (fit, fit_csr, the
BatchNorm families) and mesh serving against the meshless calls, and the
multi-process launcher. Mirrors tests/test_dist.py.

Each group of legs spawns its ranks once (dist.launch.launch_local): this
file re-runs itself as `python tests/test_torch_dist.py <leg> <outdir>`,
one process a rank at one torch thread, and the ranks save their results
for the tests to read. Only the pytest side imports jax.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
DP_CASE = dict(model={"K": 2, "M": 4, "P": 3, "s": 1, "adaptive": True},
               batch=(4, 1, 16, 16), steps=3)


def _rank_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_ranks(leg, n, out):
    """Run `leg` on n gloo ranks; returns each rank's saved results."""
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


def _checksum(params):
    return sum(float(v.abs().sum()) for v in params)


# ------------------------------------------------------------- the legs ---

def _images(n, size, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 1, size, size)).astype(np.float32)


def leg_dp(out):
    """Two ranks on {"data": 2}."""
    import torch.distributed as dist

    from cdlnet_tpu_torch.compat.jax_params import load_jax_params
    from cdlnet_tpu_torch.dist import (
        batch_sharding,
        make_dp_train_step,
        make_hybrid_mesh,
        make_mesh,
        shard_map_forward,
    )
    from cdlnet_tpu_torch.models import CDLNet, CDLNetCSR, CDLNetCSRf2, DnCNN
    from cdlnet_tpu_torch.serve import Denoiser
    from cdlnet_tpu_torch.train.fit import fit, make_train_step
    from cdlnet_tpu_torch.train.fit_csr import make_csr_train_step
    from cdlnet_tpu_torch.train.optim import make_optimizer

    res = {"rank": dist.get_rank()}
    res["specs"] = [make_mesh().shape, make_mesh({"data": -1}).shape,
                    make_mesh({"data": 1, "depth": -1}).shape,
                    make_hybrid_mesh({"data": -1}).shape]
    try:
        make_mesh({"data": 3})
        res["bad_spec"] = None
    except ValueError as e:
        res["bad_spec"] = str(e)
    mesh = make_mesh({"data": 2})
    res["rows"] = batch_sharding(torch.arange(8.0), mesh)

    # data parallelism against the JAX package's unsharded steps
    inp = np.load(os.path.join(out, "dp_inputs.npz"))
    model = CDLNet(**DP_CASE["model"])
    load_jax_params(model, {k[2:]: inp[k] for k in inp.files if k.startswith("p_")})
    opt = make_optimizer(1e-3, clip_grad=1.0)
    ostate = opt.init(dict(model.named_parameters()))

    def loss_fn(apply, b, key):
        yb, xb = b
        return torch.mean((apply(yb, 25.0) - xb) ** 2)

    step, prepare = make_dp_train_step(model, opt, loss_fn, mesh)
    ostate, batch = prepare(ostate, (inp["y"], inp["x"]))
    res["dp_losses"] = [float(step(ostate, batch)) for _ in range(DP_CASE["steps"])]
    res["dp_params"] = {k: v.detach().clone() for k, v in model.named_parameters()}

    # the sigma rules of the data-parallel forward
    fwd = shard_map_forward(mesh, lambda p, y, s, m: y * (s if s is not None else 1.0))
    y8 = torch.arange(8.0).reshape(8, 1, 1, 1)
    res["sig_scalar"] = fwd({}, y8, 2.0)
    res["sig_rows"] = fwd({}, y8, torch.arange(8.0).reshape(8, 1, 1, 1))
    res["sig_spec"] = shard_map_forward(mesh, lambda p, y, s, m: y * s.reshape(-1, 1, 1, 1),
                                        sigma_spec="shard")({}, y8, torch.arange(8.0))
    try:
        fwd({}, y8, torch.arange(8.0))
        res["sig_bare"] = None
    except ValueError as e:
        res["sig_bare"] = str(e)

    # one make_train_step(mesh=) step on the kernels against the meshless one
    def cdlnet(backend="pallas", **kw):
        m = CDLNet(**{"K": 2, "M": 6, "P": 5, "s": 2, "adaptive": True, "backend": backend,
                      **kw})
        return m.init(torch.Generator().manual_seed(0))

    batch8 = torch.from_numpy(_images(8, 32, 1))
    for name, mesh_arg in (("dp_step", mesh), ("dp_step_ref", None)):
        m = cdlnet()
        o = make_optimizer(1e-3, clip_grad=0.05)
        st = o.init(dict(m.named_parameters()))
        step2, eval2 = make_train_step(m, o, workload="2d", noise_std=(20, 30), mesh=mesh_arg)
        loss = step2(st, batch8, torch.Generator().manual_seed(5))
        res[name] = (float(loss), {k: v.detach().clone() for k, v in m.named_parameters()})
        res[name + "_ragged_eval"] = float(eval2(batch8[:3], torch.Generator().manual_seed(5)))

    # fit(mesh=) runs and improves; an indivisible batch and a 2D depth axis raise
    m = cdlnet(backend="xla", P=5, s=1, M=6)
    o = make_optimizer(1e-3, clip_grad=0.05)
    imgs = _images(8, 32, 2)
    loaders = {"train": [imgs], "val": [imgs[:1]], "test": [imgs[:1]]}
    _, hist = fit(m, o, o.init(dict(m.named_parameters())), loaders,
                  save_dir=os.path.join(out, f"fit{dist.get_rank()}"), epochs=4,
                  noise_std=25, val_freq=4, verbose=False, workload="2d",
                  mesh={"data": -1})
    res["fit_train_psnr"] = [p for _, ph, p in hist if ph == "train"]
    # fit(device_scan=True) on a stageable loader: every rank stages the
    # whole corpus, draws the same batches and takes its rows of each
    from cdlnet_tpu_torch.data.images import ImageDataset
    from cdlnet_tpu_torch.data.loader import DataLoader, ThreadSafeRng

    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths, ds.root_dirs, ds.crop_size, ds.augment = [str(i) for i in range(8)], [], 24, True
    ds.images, ds.rng = list(_images(8, 32, 9)), ThreadSafeRng(0)
    m = cdlnet(backend="pallas", M=6)
    o = make_optimizer(1e-3, clip_grad=0.05)
    _, hist = fit(m, o, o.init(dict(m.named_parameters())),
                  {"train": DataLoader(ds, batch_size=4, shuffle=True, drop_last=True),
                   "val": [imgs[:1]], "test": [imgs[:1]]},
                  save_dir=os.path.join(out, f"scan{dist.get_rank()}"), epochs=4,
                  noise_std=(20, 30), val_freq=4, verbose=False, workload="2d",
                  mesh={"data": -1}, device_scan=True)
    res["scan_fit"] = ([p for _, ph, p in hist if ph == "train"],
                       {k: v.detach().clone() for k, v in m.named_parameters()})
    for key, loaders_, spec in (("indivisible", {"train": [imgs[:3]], "val": [], "test": []},
                                 {"data": -1}),
                                ("depth_2d", loaders, {"depth": 2})):
        try:
            fit(m, o, o.init(dict(m.named_parameters())), loaders_,
                save_dir=os.path.join(out, f"raise{dist.get_rank()}"), epochs=1,
                verbose=False, workload="2d", mesh=spec)
            res[key] = None
        except ValueError as e:
            res[key] = str(e)

    # BatchNorm families: the moments of the whole batch
    for name, mesh_arg in (("bn_step", mesh), ("bn_step_ref", None)):
        m = DnCNN(K=4, M=8, P=3).init(torch.Generator().manual_seed(0))
        o = make_optimizer(1e-3, clip_grad=1.0)
        step2, _ = make_train_step(m, o, workload="2d", noise_std=(20, 30), mesh=mesh_arg)
        loss = step2(o.init(dict(m.named_parameters())), torch.from_numpy(_images(4, 16, 3)),
                     torch.Generator().manual_seed(6))
        res[name] = (float(loss), {k: v.detach().clone() for k, v in m.state_dict().items()})

    # fit_csr's data axis: one CSRf2 step against the meshless one
    vols = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (4, 1, 3, 16, 16))
                            .astype(np.float32))
    for name, mesh_arg in (("csr_step", mesh), ("csr_step_ref", None)):
        m = CDLNetCSRf2(K=2, M=4, P=3, s=1, adaptive=True, backend="pallas")
        m.init(torch.Generator().manual_seed(0))
        o = make_optimizer(1e-3, clip_grad=1.0)
        step2, _ = make_csr_train_step(m, o, noise_std=(20, 30), mesh=mesh_arg)
        loss = step2(o.init(dict(m.named_parameters())), vols, torch.Generator().manual_seed(7))
        res[name] = (float(loss), {k: v.detach().clone() for k, v in m.named_parameters()})

    # mesh serving against the meshless Denoiser
    m = cdlnet()
    imgs8 = _images(8, 64, 5)[:, 0]
    d_one, d_mesh = Denoiser(m), Denoiser(m, mesh={"data": -1})
    res["serve"] = (d_mesh.denoise_image_batch(imgs8, sigmas=25.0),
                    d_one.denoise_image_batch(imgs8, sigmas=25.0))
    sig8 = np.linspace(15, 35, 8)
    res["serve_sigmas"] = (d_mesh.denoise_image_batch(imgs8, sigmas=sig8),
                           d_one.denoise_image_batch(imgs8, sigmas=sig8))
    res["serve_ragged"] = (d_mesh.denoise_image_batch(imgs8[:3], sigmas=25.0),
                           d_one.denoise_image_batch(imgs8[:3], sigmas=25.0))
    res["serve_blind"] = (d_mesh.denoise_image_batch(imgs8), d_one.denoise_image_batch(imgs8))
    csr = CDLNetCSR(K=2, M=4, P=3, s=1, adaptive=True, backend="pallas")
    csr.init(torch.Generator().manual_seed(0), init=False)
    with torch.no_grad():
        for k in ("A", "B", "A2", "B2"):
            getattr(csr, k).mul_(0.1)
    clips = np.random.default_rng(4).uniform(0, 1, (8, 1, 4, 32, 32)).astype(np.float32)
    res["serve_csr"] = (Denoiser(csr, bucket=16, mesh={"data": -1}).denoise_video(clips, sigma=25),
                        Denoiser(csr, bucket=16).denoise_video(clips, sigma=25))
    return res


def leg_tp(out):
    """Subband tensor parallelism on {"model": n} (and {"data": 2, "model":
    2} on four ranks) against the replicated forward and step."""
    import torch.distributed as dist

    from cdlnet_tpu_torch.dist import (
        gather_subbands,
        make_mesh,
        make_subband_train_step,
        subband_forward,
        subband_shardings,
    )
    from cdlnet_tpu_torch.models import CDLNet, CDLNetVideo
    from cdlnet_tpu_torch.train.optim import make_optimizer

    n = dist.get_world_size()
    spec = {"model": 2} if n == 2 else {"data": 2, "model": 2}
    mesh = make_mesh(spec)
    data_axis = "data" if "data" in spec else None
    res = {"rank": dist.get_rank()}
    model = CDLNet(K=3, M=16, P=5, s=2, adaptive=True)
    model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.t.copy_(torch.rand(model.t.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
    y = torch.rand(8, 1, 32, 32, generator=torch.Generator().manual_seed(2))
    x = torch.rand(8, 1, 32, 32, generator=torch.Generator().manual_seed(3))
    local = {k: v.requires_grad_(True)
             for k, v in subband_shardings(dict(model.named_parameters()), mesh).items()}
    with torch.no_grad():
        res["fwd"] = (subband_forward(model, local, y, 25.0, mesh=mesh, data_axis=data_axis),
                      model(y, 25.0)[0])

    def loss_fn(apply, b, key):
        return torch.mean((apply(b[0], 25.0) - b[1]) ** 2)

    opt = make_optimizer(1e-3, clip_grad=1.0)
    step = make_subband_train_step(model, opt, loss_fn, mesh, data_axis=data_axis)
    res["loss"] = float(step(local, opt.init(local), (y, x)))
    res["params"] = gather_subbands(local, mesh)
    # the replicated step
    params = dict(model.named_parameters())
    loss = loss_fn(lambda yy, s: model(yy, s)[0], (y, x), None)
    grads = torch.autograd.grad(loss, [params[k] for k in ("A", "B", "t")])
    g = {k: gr for k, gr in zip(("A", "B", "t"), grads)}
    g["g"] = torch.zeros_like(params["g"])
    opt.update(params, g, opt.init(params))
    model.project()
    res["loss_ref"] = float(loss)
    res["params_ref"] = {k: v.detach().clone() for k, v in model.named_parameters()}
    if n == 2:  # residual blocks gather the codes they mix
        video = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=1, adaptive=True, residual=True)
        video.init(torch.Generator().manual_seed(0))
        clip = torch.rand(1, 1, 8, 16, 16, generator=torch.Generator().manual_seed(4))
        vloc = subband_shardings(dict(video.named_parameters()), mesh)
        with torch.no_grad():
            res["fwd_residual"] = (subband_forward(video, vloc, clip, 25.0, mesh=mesh),
                                   video(clip, 25.0)[0])
    return res


LEGS = {"dp": leg_dp, "tp": leg_tp, "dptp": leg_tp}


# -------------------------------------------------------------- fixtures ---

@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The dp leg on two ranks, and the JAX package's unsharded steps."""
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.train.optim import make_optimizer

    out = tmp_path_factory.mktemp("dp")
    model = build_model("CDLNet", DP_CASE["model"])
    params = model.init(jax.random.PRNGKey(0), init=False)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=DP_CASE["batch"]).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    np.savez(out / "dp_inputs.npz", y=y, x=x,
             **{"p_" + k: np.asarray(v) for k, v in params.items()})
    opt = make_optimizer(1e-3, clip_grad=1.0)
    ostate = opt.init(params)

    def loss_fn(p, b):
        out_, _ = model.apply(p, b[0], 25.0, return_z=False)
        return jnp.mean((out_ - b[1]) ** 2)

    @jax.jit
    def step(p, o, b):
        loss, grads = jax.value_and_grad(loss_fn)(p, b)
        updates, o = opt.update(grads, o, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
        return model.project(p), o, loss

    losses = []
    for _ in range(DP_CASE["steps"]):
        params, ostate, loss = step(params, ostate, (y, x))
        losses.append(float(loss))
    ck = sum(float(jnp.sum(jnp.abs(v))) for v in jax.tree_util.tree_leaves(params))
    return run_ranks("dp", 2, out), {"checksum": ck, "losses": losses}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    return run_ranks("tp", 2, tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def dptp(tmp_path_factory):
    return run_ranks("dptp", 4, tmp_path_factory.mktemp("dptp"))


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _bitwise(ranks, key):
    a, b = ranks[0][key], ranks[1][key]
    if isinstance(a, dict):
        assert all(torch.equal(a[k], b[k]) for k in a), key
    else:
        assert a == b, key


# ----------------------------------------------------------------- tests ---

def test_make_mesh_single_process_is_trivial():
    from cdlnet_tpu_torch.dist import make_mesh

    mesh = make_mesh()
    assert mesh.shape == {"data": 1} and mesh.device_mesh is None
    assert make_mesh({"data": -1, "depth": 1}).shape == {"data": 1, "depth": 1}
    assert mesh.group("data") is None and mesh.index("data") == 0
    with pytest.raises(ValueError, match="does not match 1 devices"):
        make_mesh({"data": 2})


def test_initialize_distributed_single_process_noop(monkeypatch):
    from cdlnet_tpu_torch.dist import initialize_distributed, make_hybrid_mesh

    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert make_hybrid_mesh({"data": 1, "depth": -1}).shape == {
        "replica": 1, "data": 1, "depth": 1}
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        initialize_distributed()


@pytest.mark.parametrize("hosts,nodes", [
    (["a"], 1), (["a", "a"], 1), (["a", "a", "b", "b"], 2), (["a", "b", "c"], 3),
    (["a", "b", "a", "b"], None), (["a", "a", "b"], None), (["a", "b", "b", "b"], None)])
def test_hybrid_mesh_node_count_from_host_names(hosts, nodes):
    from cdlnet_tpu_torch.dist.init import node_count

    if nodes is None:
        with pytest.raises(ValueError, match="not consecutive blocks of one size"):
            node_count(hosts)
    else:
        assert node_count(hosts) == nodes


def test_sigma_rules_single_process():
    """The trivial mesh keeps the data-parallel forward's sigma rules."""
    from cdlnet_tpu_torch.dist import make_mesh, shard_map_forward

    fwd = shard_map_forward(make_mesh(), lambda p, y, s, m: y * s)
    y = torch.ones(4, 1, 2, 2)
    assert torch.equal(fwd({}, y, 3.0), 3 * y)
    with pytest.raises(ValueError, match="ambiguous sigma shape"):
        fwd({}, y, torch.ones(4))


def test_mesh_specs_on_two_ranks(dp):
    ranks, _ = dp
    for r in ranks:
        assert r["specs"] == [{"data": 2}, {"data": 2}, {"data": 1, "depth": 2},
                              {"replica": 1, "data": 2}]
        assert r["bad_spec"] == "mesh spec {'data': 3} does not match 2 devices"


def test_batch_sharding_takes_this_ranks_rows(dp):
    ranks, _ = dp
    for r in ranks:
        assert torch.equal(r["rows"], torch.arange(4.0) + 4 * r["rank"])


def test_two_rank_data_parallel_ranks_agree_bitwise(dp):
    ranks, _ = dp
    _bitwise(ranks, "dp_params")
    assert ranks[0]["dp_losses"] == ranks[1]["dp_losses"]


def test_two_rank_data_parallel_matches_jax_unsharded_steps(dp):
    ranks, ref = dp
    ck = _checksum(ranks[0]["dp_params"][k] for k in sorted(ranks[0]["dp_params"]))
    np.testing.assert_allclose(ck, ref["checksum"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["dp_losses"], ref["losses"], rtol=1e-5)


def test_sigma_scalar_replicates_and_rows_shard(dp):
    ranks, _ = dp
    y8 = torch.arange(8.0).reshape(8, 1, 1, 1)
    for r in ranks:
        assert torch.equal(r["sig_scalar"], 2 * y8)
        assert torch.equal(r["sig_rows"], y8 * y8)
        assert torch.equal(r["sig_spec"], y8 * y8)


def test_bare_per_sample_sigma_is_rejected(dp):
    ranks, _ = dp
    for r in ranks:
        assert r["sig_bare"].startswith("ambiguous sigma shape (8,) for batch (8, 1, 1, 1)")


def test_dp_train_step_on_kernels_matches_meshless(dp):
    ranks, _ = dp
    loss, params = ranks[0]["dp_step"]
    loss_ref, params_ref = ranks[0]["dp_step_ref"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-6)
    for k in params:
        _close(params[k], params_ref[k], rtol=1e-5, atol=1e-7)
    _bitwise([{"p": ranks[0]["dp_step"][1]}, {"p": ranks[1]["dp_step"][1]}], "p")
    assert np.isfinite(ranks[0]["dp_step_ragged_eval"])
    np.testing.assert_allclose(ranks[0]["dp_step_ragged_eval"],
                               ranks[0]["dp_step_ref_ragged_eval"], rtol=1e-5)


def test_fit_with_mesh_runs_and_improves(dp):
    ranks, _ = dp
    psnr = ranks[0]["fit_train_psnr"]
    assert len(psnr) == 4 and psnr[-1] > psnr[0], psnr
    assert ranks[1]["fit_train_psnr"] == psnr


def test_fit_device_scan_on_two_ranks(dp):
    """device_scan under a two-rank data mesh: the eager runner's steps on
    the staged corpus; both ranks log the same PSNR and end bitwise equal,
    and training improves."""
    ranks, _ = dp
    psnr, params = ranks[0]["scan_fit"]
    assert len(psnr) == 4 and psnr[-1] > psnr[0], psnr
    assert ranks[1]["scan_fit"][0] == psnr
    assert all(torch.equal(params[k], ranks[1]["scan_fit"][1][k]) for k in params)


def test_fit_with_mesh_rejects_indivisible_batch(dp):
    ranks, _ = dp
    for r in ranks:
        assert "not divisible" in r["indivisible"]


def test_fit_rejects_a_depth_axis_on_images(dp):
    ranks, _ = dp
    for r in ranks:
        assert r["depth_2d"] == 'mesh axis "depth" requires a 3D workload (CDLNetVideo)'


def test_batchnorm_takes_the_whole_batch_moments(dp):
    ranks, _ = dp
    loss, state = ranks[0]["bn_step"]
    loss_ref, state_ref = ranks[0]["bn_step_ref"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    for k in state:
        _close(state[k], state_ref[k], rtol=1e-4, atol=1e-6)
    _bitwise([{"p": ranks[0]["bn_step"][1]}, {"p": ranks[1]["bn_step"][1]}], "p")


def test_fit_csr_data_axis_step_matches_meshless(dp):
    ranks, _ = dp
    loss, params = ranks[0]["csr_step"]
    loss_ref, params_ref = ranks[0]["csr_step_ref"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    for k in params:
        _close(params[k], params_ref[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("key", ["serve", "serve_sigmas", "serve_ragged", "serve_blind"])
def test_denoiser_data_mesh_matches_meshless(dp, key):
    ranks, _ = dp
    for r in ranks:
        got, ref = r[key]
        assert got.shape == ref.shape
        _close(got, ref, rtol=0, atol=1e-6)


def test_denoiser_data_mesh_csr_video_batch(dp):
    ranks, _ = dp
    for r in ranks:
        got, ref = r["serve_csr"]
        _close(got, ref, rtol=0, atol=1e-5)


def test_subband_tp_forward_matches_replicated(tp):
    for r in tp:
        got, ref = r["fwd"]
        _close(got, ref, rtol=0, atol=2e-5)


def test_subband_tp_residual_forward_matches_replicated(tp):
    for r in tp:
        got, ref = r["fwd_residual"]
        _close(got, ref, rtol=0, atol=2e-5)


def test_subband_tp_train_step_matches_replicated(tp):
    for r in tp:
        np.testing.assert_allclose(r["loss"], r["loss_ref"], rtol=1e-5)
        for k, v in r["params_ref"].items():
            _close(r["params"][k], v, rtol=1e-5, atol=1e-6)


def test_dp_tp_train_step_matches_replicated(dptp):
    for r in dptp:
        got, ref = r["fwd"]
        _close(got, ref, rtol=0, atol=2e-5)
        np.testing.assert_allclose(r["loss"], r["loss_ref"], rtol=1e-5)
        for k, v in r["params_ref"].items():
            _close(r["params"][k], v, rtol=1e-5, atol=1e-6)


def _launch_args(tmp_path, root, save):
    return {
        "type": "CDLNet",
        "model": {"K": 2, "M": 4, "P": 3, "s": 1, "adaptive": True},
        "paths": {"save": save, "ckpt": None},
        "dist": {"mesh": {"data": -1}},
        "train": {
            "loaders": {
                "trn_path_list": [root + "/train"],
                "val_path_list": [root + "/val"],
                "tst_path_list": [root + "/test"],
                "crop_size": 32, "batch_size": [2, 1, 1],
            },
            "opt": {"lr": 1e-3},
            "sched": {"step_size": 1, "gamma": 0.95},
            "fit": {"epochs": 1, "noise_std": 25, "val_freq": 5, "save_freq": 1},
        },
    }


def _assert_equal_checkpoints(a, b):
    za, zb = np.load(os.path.join(a, "net.ckpt.npz")), np.load(os.path.join(b, "net.ckpt.npz"))
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k])
    for d in (a, b):
        assert os.path.exists(os.path.join(d, "train.txt"))
        assert os.path.exists(os.path.join(d, "args.json"))


def test_launcher_two_ranks_train_cli(tmp_path):
    """python -m cdlnet_tpu_torch.dist.launch args.json with the
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID environment: two ranks
    run the train CLI on a {"dist": {"mesh": {"data": -1}}} config and keep
    equal checkpoints, each in the save dir its config names."""
    from cdlnet_tpu_torch.data.synthetic import gen_synthetic_image_dirs
    from cdlnet_tpu_torch.dist.launch import launch_local

    root = gen_synthetic_image_dirs(str(tmp_path / "imgs"), n_images=4, size=48)
    args = _launch_args(tmp_path, root, str(tmp_path / "save{rank}"))
    f = tmp_path / "args.json"
    f.write_text(json.dumps(args))
    rcs, outs = launch_local([sys.executable, "-m", "cdlnet_tpu_torch.dist.launch", str(f),
                              "--device", "cpu"], 2, env=_rank_env(), timeout=300)
    assert rcs == [0, 0], "\n".join(outs)
    _assert_equal_checkpoints(tmp_path / "save0", tmp_path / "save1")


def test_launcher_under_torchrun(tmp_path):
    """The same through python -m torch.distributed.run --nproc-per-node 2
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK)."""
    import subprocess

    from cdlnet_tpu_torch.data.synthetic import gen_synthetic_image_dirs
    from cdlnet_tpu_torch.dist.launch import free_port

    root = gen_synthetic_image_dirs(str(tmp_path / "imgs"), n_images=4, size=48)
    f = tmp_path / "args.json"
    f.write_text(json.dumps(_launch_args(tmp_path, root, str(tmp_path / "save{rank}"))))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(free_port()),
         "-m", "cdlnet_tpu_torch.dist.launch", str(f), "--device", "cpu"],
        env=_rank_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    _assert_equal_checkpoints(tmp_path / "save0", tmp_path / "save1")


if __name__ == "__main__":
    leg, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    import torch.distributed as dist

    from cdlnet_tpu_torch.dist.init import initialize_distributed, shutdown_distributed

    initialize_distributed(device="cpu")
    result = LEGS[leg](out)
    torch.save(result, os.path.join(out, f"{leg}_{dist.get_rank()}.pt"))
    shutdown_distributed()
