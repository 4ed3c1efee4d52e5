"""cdlnet_tpu_torch and chip_smoke.py stand alone: a static scan finds no
import of jax or of the JAX package. (A sys.modules check cannot show it:
jax may already be imported when the interpreter starts.)"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "cdlnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cdlnet_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_holds_the_slice():
    pkg = ROOT / "cdlnet_tpu_torch"
    for rel in ("core/pad.py", "core/preprocess.py", "core/ops.py", "core/solvers.py",
                "ops/conv.py", "ops/polyphase.py", "ops/lista.py",
                "kernels/lista3d.py", "kernels/_build.py", "kernels/csrc/lista3d.cu",
                "kernels/csrc/lista3d_bwd.cu",
                "kernels/lista3d_bwd.py", "kernels/autodiff.py",
                "models/base.py", "models/cdlnet_video.py", "train/checkpoint.py",
                "train/optim.py", "train/losses.py", "train/fit.py", "data/noise.py",
                "utils.py", "compat/jax_params.py", "serve.py",
                "core/gabor.py", "core/wavelet.py", "kernels/lista2d.py",
                "kernels/csrc/lista2d.cu", "models/cdlnet.py", "models/gdlnet.py",
                "nle/__init__.py", "nle/mad.py", "kernels/lista2d_bwd.py",
                "data/loader.py", "data/images.py", "data/synthetic.py",
                "cli/__init__.py", "cli/train.py", "cli/analyze.py", "cli/analyze3d.py",
                "data/video.py", "models/streaming.py", "models/csr.py",
                "data/fastmri.py", "cli/analyzemri.py", "train/fit_csr.py",
                "kernels/csrc/lista3d_mma.cuh", "tools/bench_video_serve.py",
                "kernels/csrc/lista2d_mma.cuh", "kernels/csrc/mma_tf32.cuh",
                "tools/bench_image_serve.py", "tools/compare_sass.py",
                "nle/pca.py", "data/prefetch.py", "models/dncnn.py",
                "compat/torch_ckpt.py", "server.py"):
        assert (pkg / rel).is_file(), rel
