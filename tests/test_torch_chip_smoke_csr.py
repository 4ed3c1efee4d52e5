"""chip_smoke.py's reference for the CSR code gradients, on the CPU: the
plain loop with each prox evaluated on given branches (csr_on_branches) is
the plain loop itself when the branches are its own, for CDLNet_CSR's
one-sided prox and CDLNet_CSRf2's two-sided one."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

WIDTH = dict(K=4, M=8, P=9, s=2, C=1, adaptive=True)
FAMILIES = ("CDLNet_CSR", "CDLNet_CSRf2")


def _setup(family, monkeypatch):
    """A frame, its neighbour codes and the plain model of `family` at a
    tiny width; the plain loop's own branches of its recurrent apply."""
    monkeypatch.setattr(cs, "CSR_WIDTH", WIDTH)
    models = cs.csr_models(torch.device("cpu"))
    f2 = models["CDLNet_CSRf2"][0]
    model, plain = models[family]
    rng = np.random.default_rng(0)
    clean = cs.smooth_clip(rng, 2, (32, 32))[None]
    y = torch.from_numpy(clean + cs.SIGMA / 255 * rng.standard_normal(clean.shape)
                         .astype(np.float32))
    with torch.no_grad():
        z_nb = {"z_prev": f2(y[:, 0:1], sigma=cs.SIGMA)[1],
                "z_after": f2(y[:, 1:2], sigma=cs.SIGMA)[1]}
    kws = ("z_prev",) if family == "CDLNet_CSR" else ("z_prev", "z_after")
    codes = {n: z_nb[n] for n in kws}
    _, _, u_plain, ths = cs.csr_branch_flips(model, y[:, 0:1], codes)
    own = [cs.csr_prox_branches(u_plain[k], codes["z_prev"], codes.get("z_after"),
                                *(ths[k] + [None])[:3]) for k in range(len(ths))]
    return plain, y[:, 0:1], codes, own


def _run(plain, codes, recurrent):
    """(xhat, z) of `recurrent(**codes)` and the gradients of a loss on
    them with respect to the parameters and the codes."""
    cd = {n: c.clone().requires_grad_() for n, c in codes.items()}
    x, z = recurrent(**cd)
    loss = (x ** 2).mean() + (z ** 2).mean()
    grads = torch.autograd.grad(loss, list(plain.parameters()) + list(cd.values()),
                                allow_unused=True)  # CDLNet_CSR's first-frame banks
    return x.detach(), z.detach(), grads


@pytest.mark.parametrize("family", FAMILIES)
def test_csr_on_branches_is_the_plain_loop_on_its_own_branches(family, monkeypatch):
    plain, y, codes, own = _setup(family, monkeypatch)
    x0, z0, g0 = _run(plain, codes, lambda **cd: plain(y, sigma=cs.SIGMA, **cd))
    x1, z1, g1 = _run(plain, codes, lambda **cd: cs.csr_on_branches(plain, y, cd, own))
    assert torch.equal(z0, z1) and torch.equal(x0, x1)
    for a, b in zip(g1, g0):
        assert (a is None) == (b is None)
        if b is not None:
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("family", FAMILIES)
def test_csr_on_branches_follows_the_given_branches(family, monkeypatch):
    """Every prox on its zero branch gives zero codes, whatever the
    argument: the branches, not the argument, pick the piece."""
    plain, y, codes, own = _setup(family, monkeypatch)
    zero = [torch.zeros_like(b) for b in own]
    with torch.no_grad():
        _, z = cs.csr_on_branches(plain, y, codes, zero)
        _, z_own = cs.csr_on_branches(plain, y, codes, own)
    assert not torch.any(z) and torch.any(z_own)
