"""PyTorch port vs JAX reference: the closed-batch serving path.

``repro_torch.serve.serve.generate`` steps a prompt block through the slot
cache and decodes; its greedy tokens must equal ``repro.serve.serve.
generate``'s on the same parameters (carried across by numpy, codes
included) at W16, W4 and W4 with empirical codebooks, on the ``*_smoke``
configs of granite_3_8b, gemma2_9b and yi_6b.  Also: the steps it is made
of, activation fake-quant (``a_bits``) against the reference's, sampling
keyed by (seed, position), telemetry, and ``run_closed_batch`` through the
CLI's ``main`` on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import activations as jact
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.serve import serve as jserve

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.core import activations as tact
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.serve import serve as tserve
from repro_torch.serve import telemetry as ttele


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("granite_3_8b", "gemma2_9b", "yi_6b")
B, S0, N_NEW = 2, 24, 14          # 38 positions: past gemma2's window of 32


@functools.lru_cache(maxsize=None)
def _dense(arch):
    p = jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _opts():
    jo = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30)
    to = tlm.ModelOpts(compute_dtype=torch.float32)
    return jo, to


def _prompts(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S0)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_bits,w_dist", [(16, "gaussian"), (4, "gaussian"),
                                           (4, "empirical")])
def test_generate_matches_reference(arch, w_bits, w_dist):
    """Greedy tokens equal to the reference's.  The reference codes its
    params with ``prepare_params``; the port takes the same codes (and
    codebooks) across by numpy, so both serve one quantized model."""
    pj, _ = _dense(arch)
    sc_j = jserve.ServeConfig(w_bits=w_bits, w_dist=w_dist)
    sc_t = tserve.ServeConfig(w_bits=w_bits, w_dist=w_dist)
    qj = jserve.prepare_params(pj, sc_j)
    qt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qj),
                                   device="cpu")
    jo, to = _opts()
    prompts = _prompts(tcb.get_smoke(arch))
    want = np.asarray(jserve.generate(qj, jcb.get_smoke(arch),
                                      jserve.make_serve_opts(jo, sc_j), sc_j,
                                      jnp.asarray(prompts), N_NEW))
    got = tserve.generate(qt, tcb.get_smoke(arch),
                          tserve.make_serve_opts(to, sc_t), sc_t,
                          torch.from_numpy(prompts), N_NEW)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, N_NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_at_a_bits_8_matches_reference(arch):
    """``--a-bits 8`` in the closed batch: W4 weights, every layer's output
    fake-quantized to int8 (``_maybe_quant_act``) on both sides."""
    pj, _ = _dense(arch)
    sc_j = jserve.ServeConfig(w_bits=4, a_bits=8)
    sc_t = tserve.ServeConfig(w_bits=4, a_bits=8)
    qj = jserve.prepare_params(pj, sc_j)
    qt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qj),
                                   device="cpu")
    jo, to = _opts()
    so_t = tserve.make_serve_opts(to, sc_t)
    assert so_t.a_bits == 8 and so_t.serve_a_bits == 32
    prompts = _prompts(tcb.get_smoke(arch), seed=1)
    want = np.asarray(jserve.generate(qj, jcb.get_smoke(arch),
                                      jserve.make_serve_opts(jo, sc_j), sc_j,
                                      jnp.asarray(prompts), N_NEW))
    got = tserve.generate(qt, tcb.get_smoke(arch), so_t, sc_t,
                          torch.from_numpy(prompts), N_NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_quant_act_matches_reference(bits, dtype):
    """Per-tensor absmax round trip: values equal to the reference's (f32:
    within one f32 rounding; bf16: bit-equal after the cast), and the
    gradient passes straight through."""
    x = (np.random.default_rng(bits).standard_normal((3, 7, 64)) * 2.0
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    want = np.asarray(jact.fake_quant_act(jx, bits).astype(jnp.float32))
    got = tact.fake_quant_act(tx, bits)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
    got.sum().backward()
    assert torch.equal(tx.grad, torch.ones_like(tx))
    assert tact.fake_quant_act(tx, 32) is tx


def test_make_steps_are_the_model_steps():
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _dense("granite_3_8b")
    _, to = _opts()
    toks = torch.from_numpy(_prompts(cfg))
    l1, kv1 = tserve.make_prefill_step(cfg, to)(pt, {"tokens": toks})
    l2, kv2 = tmodel.prefill(pt, cfg, to, {"tokens": toks})
    assert torch.equal(l1, l2) and torch.equal(kv1["k"], kv2["k"])
    c1 = tmodel.init_cache(cfg, B, 8, torch.float32, device="cpu")
    c2 = tmodel.init_cache(cfg, B, 8, torch.float32, device="cpu")
    pos = torch.zeros(B, dtype=torch.long)
    d1, _ = tserve.make_decode_step(cfg, to)(pt, c1, toks[:, :1], pos)
    d2, _ = tmodel.decode(pt, cfg, to, c2, toks[:, :1], pos)
    assert torch.equal(d1, d2) and torch.equal(c1["v"], c2["v"])


def test_sampling_is_keyed_by_seed_and_position():
    """At temperature > 0: the same seed gives the same tokens, another
    seed other tokens; a row's draw depends on (row seed, position) only,
    so a one-row batch reproduces row 0 of a two-row batch."""
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _dense("granite_3_8b")
    _, to = _opts()
    sc = tserve.ServeConfig(temperature=1.0)
    prompts = torch.from_numpy(_prompts(cfg, seed=2))

    def run(p, seed):
        return tserve.generate(pt, cfg, to, sc, p, 10, seed=seed)
    a, b, c = run(prompts, 7), run(prompts, 7), run(prompts, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(prompts[:1], 7)[0], a[0])
    greedy = tserve.generate(pt, cfg, to, tserve.ServeConfig(), prompts, 10)
    assert not torch.equal(a, greedy)
    logits = torch.randn(3, 50)
    assert torch.equal(tserve.sample(logits, 0.0),
                       torch.argmax(logits, -1).to(torch.int32))


def test_generate_telemetry_span_and_counters():
    cfg = tcb.get_smoke("yi_6b")
    _, pt = _dense("yi_6b")
    _, to = _opts()
    tel = ttele.Telemetry(enabled=True)
    out = tserve.generate(pt, cfg, to, tserve.ServeConfig(),
                          torch.from_numpy(_prompts(cfg)), 5, telemetry=tel)
    assert tuple(out.shape) == (B, 5)
    assert [s.name for s in tel.tracer.spans()] == ["generate"]
    assert tel.registry.counter("prompt_tokens").value == B * S0
    assert tel.registry.counter("tokens_decoded").value == B * 5
    # off (the default): the same tokens
    assert torch.equal(out, tserve.generate(
        pt, cfg, to, tserve.ServeConfig(), torch.from_numpy(_prompts(cfg)),
        5))


def test_generate_check_finite_raises_on_nan_logits():
    cfg = tcb.get_smoke("granite_3_8b")
    _, pt = _dense("granite_3_8b")
    _, to = _opts()
    bad = dict(pt, final_norm=torch.full_like(pt["final_norm"], np.nan))
    prompts = torch.from_numpy(_prompts(cfg))
    with pytest.raises(RuntimeError, match="non-finite logits at decode "
                                           "step 0"):
        tserve.generate(bad, cfg, to, tserve.ServeConfig(), prompts, 3,
                        check_finite=True)
    assert tuple(tserve.generate(bad, cfg, to, tserve.ServeConfig(), prompts,
                                 3).shape) == (B, 3)


@pytest.mark.parametrize("extra", [[], ["--w-dist", "empirical"],
                                   ["--a-bits", "8"], ["--w-bits", "16"],
                                   ["--debug-nans"]])
def test_run_closed_batch_through_main_on_cpu(capsys, extra):
    """The CLI without --engine: dense params drawn from --seed, then the
    coded model; prints tok/s, agreement, a sample and the compute dtype."""
    from repro_torch.launch import serve as tlaunch
    argv = ["--arch", "granite_3_8b", "--smoke", "--device", "cpu",
            "--w-bits", "4", "--batch", "2", "--prompt-len", "8",
            "--new-tokens", "8", "--seed", "3"] + extra
    stats = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "tok/s host-loop" in out and "greedy agreement" in out
    assert "sample (quantized):" in out and "compute float32" in out
    assert tuple(stats["tokens"].shape) == (2, 8)
    assert 0.0 <= stats["agreement"] <= 1.0
    if "16" in extra:
        assert stats["agreement"] == 1.0
    again = tlaunch.main(argv)
    assert torch.equal(again["tokens"], stats["tokens"])  # replays by --seed
