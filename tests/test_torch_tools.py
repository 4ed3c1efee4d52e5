"""The chip-side tools of cdlnet_tpu_torch on the CPU: their helpers, and
that they refuse to time anything without a card."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "cdlnet_tpu_torch" / "tools"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread per test process (the suite runs six)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_video_serve_buckets_native_clips():
    """The native 16x480x854 clip is timed at the Denoiser's 512x896 bucket,
    reflect-padded, as chip_smoke.py's bigframe phase times it."""
    tool = _tool("bench_video_serve")
    clip = tool.smooth(np.random.default_rng(0), 2, (480, 854))
    assert clip.shape == (2, 480, 854) and clip.min() == 0.0 and clip.max() == 1.0
    padded = tool.bucketed(clip)
    assert padded.shape == (2, 512, 896)
    np.testing.assert_array_equal(padded[:, :480, :854], clip)
    np.testing.assert_array_equal(padded[:, 480:, :854], clip[:, 478:446:-1])
    assert tool.bucketed(clip[:, :128, :128]).shape == (2, 128, 128)


@pytest.mark.parametrize("name", ["bench_video_serve", "bench_csr_serve",
                                  "bench_image_serve"])
def test_bench_tools_need_a_card(name, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("on a card the tool would run its benchmark")
    monkeypatch.setattr(sys, "argv", [name])
    assert _tool(name).main() == 1
    captured = capsys.readouterr()
    assert "needs a GPU" in captured.err and captured.out == ""


def test_compare_sass_reads_instructions_without_addresses():
    """The SASS comparison keeps each kernel's instructions and drops their
    addresses and encodings, so two builds compare by what they run."""
    text = """
\t\tFunction : _ZN5mma3d15lista3d_ana_mmaEN6tf32x37MmaArgsEb
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
\t\tFunction : other
        /*0000*/                   EXIT ;                        /* 0x000000000000794d */
"""
    got = _tool("compare_sass").parse(text)
    assert got == {"_ZN5mma3d15lista3d_ana_mmaEN6tf32x37MmaArgsEb":
                   ["LDC R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;"], "other": ["EXIT ;"]}



def test_compare_sass_pairs_a_renamed_kernel(monkeypatch, capsys):
    """OLD=NEW pairs a kernel whose mangled name changed (one that became a
    template's instantiation) with its new name; an uneven pairing fails."""
    tool = _tool("compare_sass")
    old = {"_ZN5mma3d15lista3d_ana_mmaEN6tf32x37MmaArgsEb": ["EXIT ;"]}
    new = {"_ZN5mma3d15lista3d_ana_mmaILb0EEEvN6tf32x37MmaArgsEbNS1_11AdjointArgsE": ["EXIT ;"],
           "_ZN5mma3d15lista3d_ana_mmaILb1EEEvN6tf32x37MmaArgsEbNS1_11AdjointArgsE": ["RET ;"]}
    monkeypatch.setattr(tool, "disassemble", lambda so: old if so == "old.so" else new)
    assert tool.main(["old.so", "new.so", "lista3d_ana_mmaEN=lista3d_ana_mmaILb0E"]) == 0
    assert "1 / 1 instructions, equal" in capsys.readouterr().out
    assert tool.main(["old.so", "new.so", "lista3d_ana_mma"]) == 1
    assert "1 kernels in the old build, 2 in the new" in capsys.readouterr().out
