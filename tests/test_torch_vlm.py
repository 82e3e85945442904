"""PyTorch port vs JAX reference: the vlm family (pixtral) on the serving
path (``models/lm.py``'s vlm branch, dispatched by ``models/model.py``).

One reference tree of ``pixtral_12b_smoke``, dense or coded there, is
carried across by ``convert.params_from_numpy``; prefill with precomputed
patch embeddings ahead of the prompt, the padded prefill (``pad_to``) and
decode steps from its cache, and the closed batch's greedy tokens then run
in both on the CPU in f32, from the same numpy inputs.  Also: the draw
(the dense decoder's tree), the refusals (engine, training) and the serving
CLI's closed batch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts
from repro.serve import serve as jserve

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng
from repro_torch.serve import serve as tserve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "pixtral_12b"
B, S = 2, 6

# f32 logits and K/V of O(1) after two layers, the same weights and codes
# on both sides: different summation orders and transcendental
# implementations (``test_torch_lm.py``'s TOL_LOGITS).  Stated relative to
# max(1, the largest reference value).
TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _params(w_bits, dist="gaussian"):
    p = jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(ARCH))
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits, dist=dist)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _opts():
    return (JOpts(compute_dtype=jnp.float32, remat=False,
                  attn_chunked_min_len=1 << 30),
            tlm.ModelOpts(compute_dtype=torch.float32))


_jprefill = jax.jit(jlm.forward_prefill, static_argnums=(1, 2, 4))
_jdecode = jax.jit(jmodel.decode, static_argnums=(1, 2))


def _batch(seed=0, s=S):
    cfg = jcb.get_smoke(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, s)).astype(np.int32)
    pe = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(pe)})


def _close(got, want, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


CODINGS = [(16, "gaussian"), (4, "gaussian"), (8, "gaussian"),
           (4, "empirical")]


@pytest.mark.parametrize("bits,dist", CODINGS)
def test_prefill_with_patches_matches_reference(bits, dist):
    """The patch embeddings go ahead of the tokens: logits of the last
    token and K/V over all P + S rows equal the reference's, and the
    patches move them (the prefill of the tokens alone differs)."""
    pj, pt = _params(bits, dist)
    jo, to = _opts()
    bj, bt = _batch()
    lj, cj = _jprefill(pj, jcb.get_smoke(ARCH), jo, bj, None)
    cfg = tcb.get_smoke(ARCH)
    lt, ct = tmodel.prefill(pt, cfg, to, bt)
    P = cfg.n_patches
    assert tuple(ct["k"].shape) == (cfg.n_layers, B, P + S, cfg.n_kv_heads,
                                    cfg.head_dim)
    _close(lt, lj, "logits")
    for name in ("k", "v"):
        _close(ct[name], cj[name], name)
    bare, _ = tmodel.prefill(pt, dataclasses.replace(cfg, family="dense"),
                             to, {"tokens": bt["tokens"]})
    assert not torch.allclose(bare, lt)


@pytest.mark.parametrize("bits,dist", CODINGS)
def test_padded_prefill_then_decode_matches_reference(bits, dist):
    """``forward_prefill(pad_to=P + S + 3)`` and three decode steps from
    its cache (positions P + S onward), against the reference's."""
    pj, pt = _params(bits, dist)
    jo, to = _opts()
    cfg_j, cfg_t = jcb.get_smoke(ARCH), tcb.get_smoke(ARCH)
    bj, bt = _batch(seed=1)
    n = cfg_t.n_patches + S
    lj, cj = _jprefill(pj, cfg_j, jo, bj, n + 3)
    lt, ct = tlm.forward_prefill(pt, cfg_t, to, bt, pad_to=n + 3)
    _close(lt, lj, "prefill logits")
    assert tuple(ct["k"].shape)[2] == n + 3
    nj, nt = jnp.argmax(lj, -1), lt.argmax(-1)
    for t in range(n, n + 3):
        pos = np.full((B,), t, np.int32)
        lj, cj = _jdecode(pj, cfg_j, jo, cj, nj[:, None], jnp.asarray(pos))
        lt, ct = tmodel.decode(pt, cfg_t, to, ct, nt[:, None],
                               torch.from_numpy(pos))
        _close(lt, lj, f"logits at position {t}")
        nj, nt = jnp.argmax(lj, -1), lt.argmax(-1)
    for name in ("k", "v"):
        _close(ct[name], cj[name], name)


def test_last_idx_runs_over_the_patch_rows():
    """``last_idx`` indexes the P + S rows, as in the reference."""
    pj, pt = _params(4)
    jo, to = _opts()
    bj, bt = _batch(seed=2)
    idx = np.array([tcb.get_smoke(ARCH).n_patches + 2, 3], np.int32)
    lj, _ = jmodel.prefill(pj, jcb.get_smoke(ARCH), jo, bj,
                           last_idx=jnp.asarray(idx))
    lt, _ = tmodel.prefill(pt, tcb.get_smoke(ARCH), to, bt,
                           last_idx=torch.from_numpy(idx))
    _close(lt, lj, "logits at last_idx")


@pytest.mark.parametrize("bits,dist", [(16, "gaussian"), (4, "gaussian"),
                                       (4, "empirical")])
def test_generate_matches_reference(bits, dist):
    """Greedy tokens of ``serve.generate`` equal the reference's (its
    steps see no patch embeddings: the dense decoder's decode)."""
    pj, _ = _params(16)
    sc_j = jserve.ServeConfig(w_bits=bits, w_dist=dist)
    sc_t = tserve.ServeConfig(w_bits=bits, w_dist=dist)
    qj = jserve.prepare_params(pj, sc_j)
    qt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qj),
                                   device="cpu")
    jo, to = _opts()
    prompts = np.random.default_rng(3).integers(
        0, 512, size=(B, 4)).astype(np.int32)
    want = np.asarray(jserve.generate(
        qj, jcb.get_smoke(ARCH), jserve.make_serve_opts(jo, sc_j), sc_j,
        jnp.asarray(prompts), 6))
    got = tserve.generate(qt, tcb.get_smoke(ARCH),
                          tserve.make_serve_opts(to, sc_t), sc_t,
                          torch.from_numpy(prompts), 6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_draws_the_dense_decoder_tree():
    """``model.init`` draws the vlm as the dense decoder (no patch
    projection: the patches come as embeddings), the reference's paths and
    shapes; at W4 each slice is coded as it is drawn."""
    cfg = tcb.get_smoke(ARCH)
    dense = tmodel.init(3, cfg, device="cpu")
    flat_d = dict(tlm._walk(dense))
    flat_j = dict(tlm._walk(jax.tree_util.tree_map(
        np.asarray, _params(16)[0])))
    assert set(flat_d) == set(flat_j)
    for key, a in flat_j.items():
        assert tuple(flat_d[key].shape) == a.shape, key
    coded = tmodel.init(3, cfg, device="cpu", w_bits=4)
    want = tmodel.quantize_for_serving(dense, 4, device="cpu")
    for (key, c), (kw, w) in zip(tlm._walk(coded), tlm._walk(want)):
        assert key == kw
        if tlm.is_qweight(w):
            assert all(torch.equal(c[k], w[k]) for k in w), key
        else:
            assert torch.equal(c, w), key


def test_vlm_refuses_the_engine_and_training():
    """The engine keeps the reference's ValueError (the closed batch serves
    the vlm).  Training is ported: the loss of the dense tree, patch
    embeddings ahead of the tokens, is finite through ``model.loss_fn`` and
    ``lm.forward_train`` alike (its parity with the reference is
    ``test_torch_train_families.py``'s)."""
    cfg = tcb.get_smoke(ARCH)
    _, pt = _params(4)
    _, to = _opts()
    with pytest.raises(ValueError, match="decoder-only KV families"):
        teng.Engine(pt, cfg, to, teng.EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        tmodel.init_paged_cache(cfg, 4, 8, device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "targets": torch.zeros((1, 4), dtype=torch.long),
             "patch_embeds": torch.ones((1, cfg.n_patches, cfg.d_model))}
    _, dense = _params(16)
    loss = tmodel.loss_fn(dense, cfg, to, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert torch.equal(tlm.forward_train(dense, cfg, to, batch), loss)
    assert not tmodel.supports_paged_cache(cfg)
    assert not tmodel.supports_slot_cache(cfg)


@pytest.mark.parametrize("extra", [[], ["--w-dist", "empirical"]])
def test_closed_batch_through_the_cli_on_cpu(capsys, extra):
    """The serving CLI without --engine: dense weights from --seed, then
    their W4 copy; tok/s, agreement, a sample, replayable by --seed;
    --engine raises the reference's ValueError."""
    from repro_torch.launch import serve as tlaunch
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--w-bits", "4",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "8",
            "--seed", "5"] + extra
    stats = tlaunch.main(argv)
    out = capsys.readouterr().out
    assert "tok/s host-loop" in out and "greedy agreement" in out
    assert tuple(stats["tokens"].shape) == (2, 8)
    assert 0 <= int(stats["tokens"].min()) and \
        int(stats["tokens"].max()) < 512
    assert torch.equal(tlaunch.main(argv)["tokens"], stats["tokens"])
    with pytest.raises(ValueError, match="decoder-only KV families"):
        tlaunch.main(argv[:9] + ["--engine", "--requests", "1"])
