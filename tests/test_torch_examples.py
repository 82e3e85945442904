"""The port's examples (``examples/*_torch.py``) run on the CPU at a small
size and print what their references print; their deterministic steps,
fed the reference examples' own inputs (carried over by numpy), give the
reference's numbers; without ``--device cpu`` they ask for the card and
raise where there is none."""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import GaussianModel, kquantile_dequantize, kquantile_quantize
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.serve import serve as jserve

from repro_torch import convert
from repro_torch.configs import base as tcb

# the quickstart's k-quantile relative error, port vs reference on the same
# tensor: both take the norms in f32 in their own order, a few f32 ulps of
# ~0.15 (1.5e-8 each) apart; one code flipped at a bin edge would move it
# by ~1e-5
TOL_KQ_REL_ERR = 1e-6

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart(capsys):
    _example("quickstart_torch").main(["--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    m = re.match(r"\[1\] 4-bit k-quantile: rel err ([0-9.]+), bins used "
                 r"(\d+)/16", out[0])
    assert m and float(m.group(1)) < 0.2 and int(m.group(2)) == 16
    m = re.match(r"\[2\] UNIQ QAT \(w4a8, gradual\): loss ([0-9.]+) -> "
                 r"([0-9.]+)", out[1])
    assert m
    m = re.match(r"\[3\] int4 serving: greedy agreement (\d+)%, weights "
                 r"([0-9.]+) MB -> ([0-9.]+) MB", out[2])
    assert m and float(m.group(3)) < float(m.group(2))


@jax.jit
def _ref_kquantile(w):
    """The reference quickstart's step 1 (one compiled function): the
    relative error and the codes."""
    m = GaussianModel.fit(w)
    codes = kquantile_quantize(w, m, k=16)
    w_hat = kquantile_dequantize(codes, m, k=16)
    return jnp.linalg.norm(w - w_hat) / jnp.linalg.norm(w), codes


def test_quickstart_kquantile_matches_reference():
    """Step 1 on the reference quickstart's tensor (``normal(PRNGKey(0),
    (256, 256)) * 0.02``): the reference's relative error within
    ``TOL_KQ_REL_ERR`` and the same number of bins used."""
    w = jax.random.normal(jax.random.PRNGKey(0), (256, 256)) * 0.02
    want, codes = _ref_kquantile(w)
    rel, bins = _example("quickstart_torch").kquantile_demo(
        torch.from_numpy(np.array(w)))
    assert bins == len(np.unique(np.asarray(codes)))
    assert abs(rel - float(want)) <= TOL_KQ_REL_ERR, (rel, float(want))


def test_serve_quantized_lm_matches_reference():
    """The serving example on the reference example's weights
    (``init(PRNGKey(0))`` of yi_6b_smoke) and prompts (``randint(PRNGKey(1),
    (2, 8))``): the dense and the W4 greedy tokens, and both weight byte
    counts, equal to the reference example's."""
    cfg = jcb.get_smoke("yi_6b")
    opts = JOpts(compute_dtype=jnp.float32, remat=False,
                 attn_chunked_min_len=1 << 30, ssd_chunk=16)
    params = jmodel.init(jax.random.PRNGKey(0), cfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                 cfg.vocab)
    sc = jserve.ServeConfig(w_bits=4)
    out_fp = jserve.generate(params, cfg, opts, sc, prompts, 4)
    params_q = jserve.prepare_params(params, sc)
    out_q = jserve.generate(params_q, cfg, opts, sc, prompts, 4)
    bytes_fp = sum(x.size * 4 for x in jax.tree.leaves(params))
    bytes_q = sum(x.nbytes for x in jax.tree.leaves(params_q))

    got = _example("serve_quantized_lm_torch").serve_both(
        convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  device="cpu"),
        tcb.get_smoke("yi_6b"), torch.from_numpy(np.array(prompts)), 4, 4,
        "cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(out_fp))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(out_q))
    assert (got[2], got[3]) == (bytes_fp, bytes_q)


def test_serve_quantized_lm(capsys):
    _example("serve_quantized_lm_torch").main(
        ["--device", "cpu", "--batch", "2", "--new-tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=yi_6b_smoke  W4 weights:")
    m = re.search(r"over 4 tokens: ([0-9.]+)%", out[1])
    assert m and 0.0 <= float(m.group(1)) <= 100.0
    for line in out[2:]:
        toks = eval(line.split(":", 1)[1])     # noqa: S307 - our own print
        assert len(toks) == 4


def test_train_cnn_uniq(capsys):
    _example("train_cnn_uniq_torch").main(
        ["--device", "cpu", "--steps", "4", "--width", "4", "--batch", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("fp32 baseline     : acc=")
    assert out[1].startswith("UNIQ w4a8 (gradual): acc=")
    assert out[2].startswith("accuracy gap:")


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "serve_quantized_lm_torch",
                                  "train_cnn_uniq_torch"])
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _example(name).main(["--steps", "1"] if name != "serve_quantized_lm"
                            "_torch" else ["--new-tokens", "1"])
