"""PyTorch port vs JAX reference: the state-space families on the serving
path (``models/hybrid.py``, dispatched by ``models/model.py``).

One reference tree of each smoke config (``mamba2_1_3b_smoke``, family ssm;
``zamba2_2_7b_smoke``, family hybrid), dense or coded there at W4 / W8, is
carried across by ``convert.params_from_numpy``; prefill, decode and their
caches then run in both on the CPU in f32.  Also: the port's own coding of
these trees against the reference's, its layer-by-layer draw, decode
stepping against prefill, ``generate``'s greedy tokens against the
reference's, ``--a-bits 8`` (which the reference applies at prefill only),
the refusals (engine, paged cache, training), the cache layouts and the
serving CLI's closed batch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.configs.base import ShapeConfig
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


ARCHS = ("mamba2_1_3b", "zamba2_2_7b")
B, S = 2, 12

# f32 logits and caches after 2 (mamba2) / 4 + 2 shared (zamba2) layers,
# the same weights and codes on both sides: only summation orders and
# transcendental implementations differ (read: <= 5e-6).  Stated relative
# to max(1, the largest reference value).
TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _params(arch, w_bits, dist="gaussian"):
    p = _dense_ref(arch)
    if w_bits < 16:
        p = jmodel.quantize_for_serving(p, w_bits, dist=dist)
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


@functools.lru_cache(maxsize=None)
def _dense_ref(arch):
    return jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))


def _opts(a_bits=32):
    jo = JOpts(compute_dtype=jnp.float32, remat=False,
               attn_chunked_min_len=1 << 30, a_bits=a_bits)
    to = tlm.ModelOpts(compute_dtype=torch.float32, a_bits=a_bits)
    return jo, to


# the reference's steps, compiled once per (config, options, tree layout)
_jprefill = jax.jit(jmodel.prefill, static_argnums=(1, 2))
_jdecode = jax.jit(jmodel.decode, static_argnums=(1, 2))


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _close(got, want, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _caches_close(ct, cj, what):
    assert set(ct) == set(cj), what
    for name in cj:
        assert str(ct[name].dtype).replace("torch.", "") == \
            str(cj[name].dtype), (what, name)
        _close(ct[name], cj[name], f"{what} {name}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", [16, 4, 8])
def test_prefill_matches_reference(arch, bits):
    """Last-position logits and the whole decode cache (conv windows, SSM
    states, zamba2's shared K/V) equal the reference's."""
    pj, pt = _params(arch, bits)
    jo, to = _opts()
    toks = _tokens(jcb.get_smoke(arch))
    lj, cj = _jprefill(pj, jcb.get_smoke(arch), jo,
                       {"tokens": jnp.asarray(toks)})
    lt, ct = tmodel.prefill(pt, tcb.get_smoke(arch), to,
                            {"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (B, 512)
    _close(lt, lj, "logits")
    _caches_close(ct, cj, "prefill cache")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", [16, 4, 8])
def test_decode_matches_reference(arch, bits):
    """Four decode steps from a zeroed cache of 8 rows: logits at every
    step and the cache after the last, which the port writes in place."""
    pj, pt = _params(arch, bits)
    jo, to = _opts()
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    cj = jmodel.init_cache(cfg_j, ShapeConfig("d", 8, B, "decode"),
                           dtype=jnp.float32)
    ct = tmodel.init_cache(cfg_t, B, 8, torch.float32, device="cpu")
    toks = _tokens(cfg_j, seed=1)
    for t in range(4):
        pos = np.full((B,), t, np.int32)
        lj, cj = _jdecode(pj, cfg_j, jo, cj, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos))
        lt, out = tmodel.decode(pt, cfg_t, to, ct,
                                torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
        assert out is ct
        _close(lt, lj, f"logits at step {t}")
    _caches_close(ct, cj, "decode cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_stepping_matches_prefill(arch):
    """Stepping a prompt through ``decode`` gives ``prefill``'s last
    logits and its cache (zamba2's K/V in the first S rows)."""
    _, pt = _params(arch, 4)
    _, to = _opts()
    cfg = tcb.get_smoke(arch)
    toks = torch.from_numpy(_tokens(cfg, seed=2))
    lp, cp = tmodel.prefill(pt, cfg, to, {"tokens": toks})
    cache = tmodel.init_cache(cfg, B, S, torch.float32, device="cpu")
    for t in range(S):
        ld, cache = tmodel.decode(pt, cfg, to, cache, toks[:, t:t + 1],
                                  torch.full((B,), t, dtype=torch.long))
    _close(ld, lp.numpy(), "logits")
    for name in cp:
        _close(cache[name], cp[name].numpy(), name)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _coded_paths(tree):
    return {keys[:-1] for keys, _ in _flat(tree) if keys[-1] == "q_codes"}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_for_serving_matches_reference(arch):
    """The port's coding of the reference's dense tree: the same leaves
    coded (stacked ``layers/in_proj`` / ``out_proj`` per layer, ``shared/*``
    unstacked, embed and head; the SSM vectors, conv and norms dense),
    every shape and dtype equal, the codes equal but for the pinned
    bin-edge flips (at most 1e-4 of them, as the dense family's test)."""
    _, pt_dense = _params(arch, 16)
    want_coded = {("embed",), ("lm_head",), ("layers", "in_proj"),
                  ("layers", "out_proj")}
    if arch == "zamba2_2_7b":
        want_coded |= {("shared", n) for n in ("wq", "wk", "wv", "wo",
                                                "w_gate", "w_up", "w_down")}
    for bits in (4, 8):
        pj_q, _ = _params(arch, bits)
        pt_q = tmodel.quantize_for_serving(pt_dense, bits, device="cpu")
        flat_j = dict(_flat(jax.tree_util.tree_map(np.asarray, pj_q)))
        flat_t = dict(_flat(pt_q))
        assert set(flat_j) == set(flat_t)
        assert _coded_paths(pt_q) == _coded_paths(pj_q) == want_coded
        flips = total = 0
        for key, tj in flat_j.items():
            tt = flat_t[key]
            assert tuple(tt.shape) == tj.shape, key
            assert str(tt.dtype).replace("torch.", "") == tj.dtype.name, key
            if key[-1] == "q_codes":
                if bits == 8:
                    d = np.abs(tj.astype(int) - tt.numpy().astype(int))
                    assert d.max() <= 1, key
                    flips += int((d > 0).sum())
                else:
                    flips += int((tj != tt.numpy()).sum())
                total += tj.size * (2 if bits == 4 else 1)
            else:
                np.testing.assert_allclose(tt.numpy(), tj, rtol=1e-5,
                                           atol=1e-7)
        assert flips / total <= 1e-4, (bits, flips, total)
    # the empirical codebooks: the same leaves, one (k,) codebook a layer
    pj_e, _ = _params(arch, 4, "empirical")
    pt_e = tmodel.quantize_for_serving(pt_dense, 4, dist="empirical",
                                       device="cpu")
    assert _coded_paths(pt_e) == _coded_paths(pj_e) == want_coded
    L = tcb.get_smoke(arch).n_layers
    assert tuple(pt_e["layers"]["in_proj"]["q_lut"].shape) == (L, 16)
    assert tuple(pt_e["lm_head"]["q_lut"].shape) == (16,)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_dist", ["gaussian", "empirical"])
def test_init_codes_each_layer_as_quantize_codes_the_dense_draw(arch,
                                                                 w_dist):
    """``model.init(..., w_bits=4)`` codes each slice as it is drawn: the
    same tree as coding the dense draw afterwards.  The SSM leaves stay
    f32 whatever ``dense_dtype`` is; the coded-away matrices take it."""
    cfg = tcb.get_smoke(arch)
    dense = tmodel.init(3, cfg, device="cpu")
    coded = tmodel.init(3, cfg, device="cpu", w_bits=4, w_dist=w_dist)
    want = tmodel.quantize_for_serving(dense, 4, dist=w_dist, device="cpu")
    flat_c, flat_w = dict(_flat(coded)), dict(_flat(want))
    assert set(flat_c) == set(flat_w)
    for key, t in flat_w.items():
        assert torch.equal(flat_c[key], t), key
    bf = tmodel.init(3, cfg, device="cpu", dense_dtype=torch.bfloat16)
    lay = bf["layers"]
    for name in ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_scale",
                 "pre_norm"):
        assert lay[name].dtype == torch.float32, name
        assert torch.equal(lay[name], dense["layers"][name]), name
    assert lay["in_proj"].dtype == torch.bfloat16
    assert torch.equal(lay["in_proj"], dense["layers"]["in_proj"].to(
        torch.bfloat16))
    # the dt bias: softplus(dt_bias) spans [1e-3, 1e-1]
    sp = torch.nn.functional.softplus(dense["layers"]["dt_bias"])
    assert float(sp.min()) >= 1e-3 * (1 - 1e-5)
    assert float(sp.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_dist", ["gaussian", "empirical"])
def test_generate_matches_reference(arch, w_dist):
    """Greedy tokens of ``serve.generate`` at W4 equal the reference's:
    the reference codes its params with ``prepare_params``, the port takes
    the same codes (and codebooks) across."""
    pj = _dense_ref(arch)
    sc_j = jserve.ServeConfig(w_bits=4, w_dist=w_dist)
    sc_t = tserve.ServeConfig(w_bits=4, w_dist=w_dist)
    qj = jserve.prepare_params(pj, sc_j)
    qt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, qj),
                                   device="cpu")
    jo, to = _opts()
    prompts = _tokens(jcb.get_smoke(arch), seed=3, shape=(B, 6))
    want = np.asarray(jserve.generate(qj, jcb.get_smoke(arch),
                                      jserve.make_serve_opts(jo, sc_j), sc_j,
                                      jnp.asarray(prompts), 5))
    got = tserve.generate(qt, tcb.get_smoke(arch),
                          tserve.make_serve_opts(to, sc_t), sc_t,
                          torch.from_numpy(prompts), 5)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_bits_8_applies_at_prefill_only_as_in_the_reference(arch):
    """The reference fake-quantizes each Mamba layer's output at prefill
    (``_mamba_layer_apply``) but not in its decode steps, so the closed
    batch's ``--a-bits 8`` leaves these families' decode unchanged.  The
    port does the same: its decode at a_bits 8 equals its decode at 32 to
    the bit, as the reference's does, and its prefill at 8 matches the
    reference's prefill at 8 (and moves away from the prefill at 32)."""
    pj, pt = _params(arch, 4)
    jo8, to8 = _opts(8)
    jo, to = _opts()
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    toks = _tokens(cfg_j, seed=4)
    cj = jmodel.init_cache(cfg_j, ShapeConfig("d", 4, B, "decode"),
                           dtype=jnp.float32)
    pos = jnp.zeros((B,), jnp.int32)
    lj8, _ = _jdecode(pj, cfg_j, jo8, cj, jnp.asarray(toks[:, :1]), pos)
    lj, _ = _jdecode(pj, cfg_j, jo, cj, jnp.asarray(toks[:, :1]), pos)
    np.testing.assert_array_equal(np.asarray(lj8), np.asarray(lj))
    lt8, _ = tmodel.decode(pt, cfg_t, to8,
                           tmodel.init_cache(cfg_t, B, 4, torch.float32,
                                             device="cpu"),
                           torch.from_numpy(toks[:, :1]),
                           torch.zeros(B, dtype=torch.long))
    lt, _ = tmodel.decode(pt, cfg_t, to,
                          tmodel.init_cache(cfg_t, B, 4, torch.float32,
                                            device="cpu"),
                          torch.from_numpy(toks[:, :1]),
                          torch.zeros(B, dtype=torch.long))
    assert torch.equal(lt8, lt)
    pj8, _ = _jprefill(pj, cfg_j, jo8, {"tokens": jnp.asarray(toks)})
    pt8, _ = tmodel.prefill(pt, cfg_t, to8, {"tokens": torch.from_numpy(toks)})
    pt32, _ = tmodel.prefill(pt, cfg_t, to, {"tokens": torch.from_numpy(toks)})
    _close(pt8, pj8, "prefill logits at a_bits 8")
    assert not torch.equal(pt8, pt32)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_space_families_refuse_what_they_do_not_serve(arch):
    """The engine keeps the reference's ValueError; the paged pool and
    padded prefill are refused as in the reference.  Training is ported:
    the loss of the dense tree is finite (its parity with the reference is
    ``test_torch_train_families.py``'s)."""
    cfg = tcb.get_smoke(arch)
    _, pt = _params(arch, 4)
    _, to = _opts()
    with pytest.raises(ValueError, match="decoder-only KV families"):
        teng.Engine(pt, cfg, to, teng.EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="last_idx"):
        tmodel.prefill(pt, cfg, to, {"tokens": torch.zeros((1, 4),
                                                           dtype=torch.long)},
                       last_idx=torch.zeros(1, dtype=torch.long))
    cache = tmodel.init_cache(cfg, 1, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="paged decode"):
        tmodel.decode(pt, cfg, to, cache,
                      torch.zeros((1, 1), dtype=torch.long),
                      torch.zeros(1, dtype=torch.long),
                      block_tables=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="paged cache"):
        tmodel.init_paged_cache(cfg, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        tmodel.prefill_chunk(pt, cfg, to, cache, None, None, None, None,
                             None, None)
    with pytest.raises(ValueError, match="slot cache"):
        tmodel.init_slot_cache(cfg, 2, 8, device="cpu")
    _, dense = _params(arch, 16)
    toks = torch.from_numpy(_tokens(cfg))
    loss = tmodel.loss_fn(dense, cfg, to, {"tokens": toks, "targets": toks})
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert not tmodel.supports_paged_cache(cfg)
    assert not tmodel.supports_slot_cache(cfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_layout_matches_reference(arch, dtype):
    """``init_cache`` / ``cache_specs``: the reference's shapes and dtypes
    (the conv window in the cache dtype, the SSM state f32, zamba2's K/V
    (groups, B, max_len, KV, hd)); mamba2's ignores max_len."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for cfg_j, cfg_t in ((jcb.get_smoke(arch), tcb.get_smoke(arch)),
                         (jcb.get(arch), tcb.get(arch))):
        want = jmodel.cache_specs(cfg_j, ShapeConfig("d", 40, 3, "decode"),
                                  dtype=jdt)
        specs = tmodel.cache_specs(cfg_t, 3, 40, dtype)
        assert set(specs) == set(want)
        for name, w in want.items():
            got = specs[name]
            assert got.device.type == "meta"
            assert tuple(got.shape) == w.shape, name
            assert str(got.dtype).replace("torch.", "") == str(w.dtype), name
    cache = tmodel.init_cache(tcb.get_smoke(arch), 3, 40, dtype,
                              device="cpu")
    assert all(not leaf.any() for leaf in cache.values())
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_trees_and_caches(arch):
    """``params_from_numpy`` carries the reference's mamba / zamba trees
    (dense and coded) leaf for leaf, and ``cache_to_numpy`` its caches
    back."""
    for bits in (16, 4):
        pj, pt = _params(arch, bits)
        flat_j = dict(_flat(jax.tree_util.tree_map(np.asarray, pj)))
        flat_t = dict(_flat(pt))
        assert set(flat_j) == set(flat_t)
        for key, a in flat_j.items():
            np.testing.assert_array_equal(flat_t[key].numpy(), a)
    cache = tmodel.init_cache(tcb.get_smoke(arch), 2, 6, torch.bfloat16,
                              device="cpu")
    cache["conv"].normal_()
    back = convert.cache_to_numpy(cache)
    assert back["conv"].dtype == np.float32 and back["ssm"].dtype == \
        np.float32
    np.testing.assert_array_equal(back["conv"],
                                  cache["conv"].to(torch.float32).numpy())


def test_shared_attention_raises_where_the_reference_would_chunk():
    cfg = tcb.get_smoke("zamba2_2_7b")
    _, pt = _params("zamba2_2_7b", 16)
    _, to = _opts()
    toks = torch.from_numpy(_tokens(cfg, shape=(1, 8)))
    # from S = attn_chunked_min_len on the shared block attends in KV
    # chunks (as the reference's); below it the materialized path runs
    want, _ = tmodel.prefill(pt, cfg, to, {"tokens": toks})
    for kc in (2, 8, 3):
        got, _ = tmodel.prefill(pt, cfg, dataclasses.replace(
            to, attn_chunked_min_len=8, kv_chunk=kc), {"tokens": toks})
        # f32, the softmax summed in another order: 1e-5 of the logits
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(
                                       want.abs().max())))
    got, _ = tmodel.prefill(pt, cfg, dataclasses.replace(
        to, attn_chunked_min_len=9), {"tokens": toks})
    assert torch.equal(got, want)


def test_grouped_layers_take_both_tree_forms():
    """The layer loop (the shared block after every ``attn_every`` layers)
    gives the same decode step on the stacked tree and on the per-layer
    list that ``generate`` slices once."""
    cfg = tcb.get_smoke("zamba2_2_7b")
    _, pt = _params("zamba2_2_7b", 4)
    _, to = _opts()
    flat = tlm.unstack_layers(pt, cfg.n_layers)
    assert isinstance(flat["layers"], list) \
        and len(flat["layers"]) == cfg.n_layers
    toks = torch.from_numpy(_tokens(cfg, shape=(B, 1)))
    pos = torch.tensor([0, 3])
    outs = [tmodel.decode(tree, cfg, to,
                          tmodel.init_cache(cfg, B, 8, torch.float32,
                                            device="cpu"), toks, pos)
            for tree in (pt, flat)]
    (lg, cg), (lf, cf) = outs
    assert torch.equal(lg, lf)
    assert set(cg) == {"conv", "ssm", "k", "v"} and set(cf) == set(cg)
    for name in cg:
        assert torch.equal(cg[name], cf[name]), name
    # one K/V row written per group, at each row's position
    written = cg["k"].abs().sum(dim=(-1, -2)) > 0      # (groups, B, 8)
    assert written.shape[0] == cfg.n_layers // cfg.attn_every
    assert written.sum().item() == written.shape[0] * B
    assert written[:, 0, 0].all() and written[:, 1, 3].all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("extra", [[], ["--w-dist", "empirical"]])
def test_closed_batch_through_the_cli_on_cpu(capsys, arch, extra):
    """The serving CLI without --engine: dense weights from --seed, then
    their W4 copy; tok/s, agreement, a sample, replayable by --seed."""
    from repro_torch.launch import serve as tlaunch
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--w-bits", "4",
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
