"""Import hygiene of the PyTorch port: it imports torch, numpy and the
standard library — never jax, never the JAX package — and it can be
imported where there is no CUDA compiler, no triton and no card."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    examples = os.path.join(ROOT, "examples")
    out += [os.path.join(examples, f) for f in os.listdir(examples)
            if f.endswith("_torch.py")]
    return sorted(out)


def _imports(tree):
    """(top-level module name, node, enclosing function or None)."""
    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Import):
                for a in child.names:
                    yield a.name.split(".")[0], child, func
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield (child.module or "").split(".")[0], child, func
            yield from visit(child, inner)
    yield from visit(tree, None)


SOURCES = _sources()


def test_the_walk_sees_the_package():
    names = {os.path.relpath(p, ROOT) for p in SOURCES}
    assert "chip_smoke.py" in names
    for mod in ("kernels/qmatmul.py", "kernels/paged_attn.py",
                "kernels/loader.py", "models/lm.py", "serve/engine.py",
                "serve/scheduler.py", "launch/serve.py", "convert.py",
                "kernels/uniq_noise.py", "core/noise.py", "core/uniq.py",
                "optim/optim.py", "data/synthetic.py",
                "checkpoint/checkpoint.py", "train/steps.py",
                "launch/train.py", "tree.py", "kernels/kquantile.py",
                "core/activations.py", "core/bops.py", "core/quantizers.py",
                "cnn/__init__.py", "cnn/cnn.py", "cnn/train.py",
                "configs/resnet18_cifar.py", "configs/mobilenet_cifar.py",
                "models/ssm.py", "models/hybrid.py", "models/encdec.py",
                "analysis/findings.py", "analysis/modelcheck.py",
                "analysis/lint.py", "analysis/compile_audit.py",
                "analysis/kernel_audit.py", "analysis/check.py",
                "analysis/traceview.py", "parallel/sharding.py",
                "parallel/collectives.py", "parallel/tensor_parallel.py",
                "launch/mesh.py"):
        assert os.path.join("src", "repro_torch", mod) in names
    for ex in ("quickstart_torch.py", "serve_quantized_lm_torch.py",
               "train_cnn_uniq_torch.py"):
        assert os.path.join("examples", ex) in names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_no_jax_and_no_reference_package(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for name, node, func in _imports(tree):
        assert name not in FORBIDDEN, \
            f"{path}:{node.lineno} imports {name}"
        if name == "triton":
            assert func is not None, \
                f"{path}:{node.lineno}: triton is imported at module level"


def test_csrc_has_the_kernel_sources_and_no_library_products():
    csrc = os.path.join(PKG, "kernels", "csrc")
    # the four kernel sources, and the launch records they share with the
    # kernel audit (a header, compiled into each)
    names = sorted(n for n in os.listdir(csrc) if n != "launch_audit.cuh")
    assert names == ["kquantile.cu", "paged_attn.cu", "qmatmul.cu",
                     "uniq_noise.cu"]
    assert os.path.isfile(os.path.join(csrc, "launch_audit.cuh"))
    for n in names:
        with open(os.path.join(csrc, n)) as fh:
            text = fh.read()
        for banned in ("cublas", "cutlass", "curand", "torch/extension.h",
                       "atomicAdd"):
            assert banned not in text, f"{n} mentions {banned}"
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.serve, "
        "repro_torch.convert, repro_torch.kernels.ops\n"
        "import repro_torch.launch.train, repro_torch.train.steps, "
        "repro_torch.optim.optim, repro_torch.data.synthetic, "
        "repro_torch.checkpoint.checkpoint, repro_torch.core.noise, "
        "repro_torch.kernels.uniq_noise, repro_torch.kernels.kquantile, "
        "repro_torch.core.activations\n"
        "import repro_torch.cnn.train, repro_torch.cnn.cnn, "
        "repro_torch.core.bops, repro_torch.core.quantizers, "
        "repro_torch.configs.resnet18_cifar, "
        "repro_torch.configs.mobilenet_cifar\n"
        "import repro_torch.models.ssm, repro_torch.models.hybrid, "
        "repro_torch.models.encdec\n"
        "import repro_torch.analysis.check, "
        "repro_torch.analysis.modelcheck, repro_torch.analysis.lint, "
        "repro_torch.analysis.compile_audit, "
        "repro_torch.analysis.kernel_audit\n"
        "import repro_torch.parallel.sharding, "
        "repro_torch.parallel.collectives, "
        "repro_torch.parallel.tensor_parallel, repro_torch.launch.mesh\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable,
                          os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""             # no result line of any kind
