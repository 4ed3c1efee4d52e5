"""The kernel matrix tool (cdlnet_tpu_torch/tools/kernel_sweep.py) on the
CPU: its cases are KERNELMATRIX.json's, letter for letter, and a tiny-shape
run of each (the kernels' wrappers on their plain versions against backend
"xla") passes with a numeric row under a numeric bound."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from cdlnet_tpu_torch.tools import kernel_sweep as ks

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several test processes
    on a few cores, where each process's thread pool would otherwise spin
    against the others' (and the JAX files') on these small shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrix_names():
    return [row["case"] for row in json.loads((ROOT / "KERNELMATRIX.json").read_text())["cases"]]


def test_case_names_are_the_kernel_matrix():
    names = [name for name, _ in ks.Sweep("cpu", tiny=True).cases()]
    assert len(names) == 25
    assert names == _matrix_names()


@pytest.mark.parametrize("name", _matrix_names())
def test_tiny_case_passes_with_a_numeric_row(name):
    rows = ks.run_sweep("cpu", tiny=True, only=name, log=None)
    row = next(r for r in rows if r["case"] == name)
    assert row["ok"], row
    for key in ("rel_vs_xla", "bound", "sec"):
        assert isinstance(row[key], float) and np.isfinite(row[key]), (key, row)
    assert row["rel_vs_xla"] < row["bound"] and row["bound"] in (
        ks.FWD_TOL, ks.GRAD_TOL, ks.CSR_FWD_TOL, ks.CSR_GRAD_TOL, ks.LANE_TOL)
    if " train" in name:  # the float64 "xla" beside the fp32 one, per leaf
        for k_xla, k_f64, xla_f64 in row["leaves"].values():
            assert k_f64 <= max(row["bound"], ks.F64_FACTOR * xla_f64)
        assert row["gate_value"] == row["leaves"][row["gate_leaf"]][1] <= row["limit"]
        assert "loss" in row["leaves"] and row["jax_metric"] < row["bound"]


def test_main_writes_the_rows_and_fails_on_a_row_past_its_bound(tmp_path, monkeypatch):
    out = tmp_path / "sweep.json"
    args = ["kernel_sweep.py", "--out", str(out), "--device", "cpu", "--tiny",
            "--only", "csr CDLNet_CSR n_codes=1"]
    monkeypatch.setattr(sys, "argv", args)
    assert ks.main() == 0
    result = json.loads(out.read_text())
    assert result["all_ok"] and [r["case"] for r in result["cases"]] == [
        "csr CDLNet_CSR n_codes=1 eval", "csr CDLNet_CSR n_codes=1 train"]
    monkeypatch.setattr(ks, "CSR_FWD_TOL", 0.0)
    assert ks.main() == 1
    assert not json.loads(out.read_text())["all_ok"]
