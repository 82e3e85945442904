"""PyTorch port vs JAX reference: the MoE family's pieces.

The same numpy inputs, made from a seed, go through ``repro.models.moe`` /
``repro.models.lm`` (JAX, CPU) and ``repro_torch.models.moe`` /
``repro_torch.models.lm`` (``device="cpu"``): the router, the capacity, the
drop rule and the whole ``moe_ffn_local`` at f32 and bf16, with and
without drops; the expert matmuls' plain versions against the reference's
``materialize`` + ``einsum`` on coded stacks (W4 / W8 / codebook); the
stacked expert coding of ``init_params``; ``convert`` on an MoE tree; the
registry of every reference architecture.  The engine and ``generate`` on
the MoE configs are ``tests/test_torch_moe_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.models import model as jmodel
from repro.models import moe as jmoe

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
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


MOE_ARCHS = ("kimi_k2_1t_a32b", "llama4_maverick_400b_a17b")
# ported for the closed batch only (audio, vlm): the engine refuses them
NOT_PORTED = ("pixtral_12b", "whisper_base")
# ported for the closed batch only: no KV pool, so no engine
SSM_ARCHS = ("mamba2_1_3b", "zamba2_2_7b")

# router weights: f32 x @ W, softmax, top-k, renorm in both frameworks;
# only the summation order of the (T, d) @ (d, E) product differs
TOL_ROUTER = 1e-6
# the MoE FFN at f32, same weights: TOL_LOGITS of test_torch_lm.py (the
# dense FFN's and the model's f32 bound)
TOL_F32 = 2e-4
# at bf16 the expert products are rounded to bf16 after f32 sums taken in
# another order, so an element may land one bf16 ulp (2^-8 relative) away,
# and the k copies' bf16 sums carry it: 3 ulps of the output's scale
TOL_BF16_REL = 3 * 2.0 ** -8


def _rng(seed):
    return np.random.default_rng(seed)


def _dropping_cf(T, k, E):
    """A capacity factor whose capacity is about 3/4 of the mean load
    T * k / E (a multiple of 8): about a quarter of the copies drop."""
    mean = T * k / E
    C = max(8, 8 * int(0.75 * mean / 8))
    return (C - 1) / mean


def _x(T, d, seed):
    return _rng(seed).standard_normal((T, d)).astype(np.float32)


def _router(d, E, seed):
    return (_rng(seed).standard_normal((d, E)) / np.sqrt(d)).astype(
        np.float32)


def _stack(E, d, f, seed, in_axis=-2):
    w = _rng(seed).standard_normal((E, d, f)).astype(np.float32)
    return w / np.sqrt(w.shape[in_axis]).astype(np.float32)


def _coded(w, bits, dist="gaussian"):
    """A (E, K, N) stack coded as the reference codes a stacked (1, E, K,
    N) layer leaf (statistics over all E * K rows per column, or one
    codebook), layer 0 sliced off: numpy dicts."""
    tree = {"layers": {"eg": jnp.asarray(w)[None]}}
    q = jlm.quantize_params_for_serving(tree, bits, dist=dist)["layers"]
    return {k: np.asarray(v)[0] for k, v in q["eg"].items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# -- router and capacity -----------------------------------------------------

@pytest.mark.parametrize("T,d,E,k", [(64, 64, 8, 2), (37, 48, 4, 1),
                                     (128, 32, 16, 4)])
def test_router_topk_matches_reference(T, d, E, k):
    x, w = _x(T, d, 1), _router(d, E, 2)
    cfg_j, cfg_t = jmoe.MoEConfig(E, k), tmoe.MoEConfig(E, k)
    gj, ij = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), cfg_j)
    gt, it = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w),
                              cfg_t)
    # ties: the k-th and (k+1)-th probabilities within rounding; 0 here
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    top = torch.sort(probs, dim=-1, descending=True).values
    gaps = top[:, k - 1] - top[:, k] if k < E else torch.ones(T)
    assert int((gaps <= TOL_ROUTER).sum()) == 0
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=TOL_ROUTER)
    np.testing.assert_allclose(gt.sum(-1).numpy(), 1.0, atol=1e-6)


def test_capacity_matches_reference():
    for T in (1, 7, 16, 100, 256, 2048):
        for E in (4, 8, 128, 384):
            for k in (1, 2, 8):
                for cf in (0.5, 1.0, 1.25, 1.5, 64.0):
                    assert tmoe.capacity(T, tmoe.MoEConfig(E, k, cf)) == \
                        jmoe.capacity(T, jmoe.MoEConfig(E, k, cf))


# -- the drop rule and moe_ffn_local -----------------------------------------

def _kept_reference(x, router, E, k, cf):
    """The reference's kept (token, expert) copies, read from its own
    ``moe_ffn_local``: probe experts whose output lands in column e alone
    (down_w zero elsewhere), so y[t, e] != 0 iff token t's copy to expert
    e was kept."""
    T, d = x.shape
    f = 8
    r = _rng(9)
    g = r.standard_normal((E, d, f)).astype(np.float32)
    u = r.standard_normal((E, d, f)).astype(np.float32)
    dn = np.zeros((E, f, d), np.float32)
    for e in range(E):
        dn[e, :, e] = r.standard_normal(f) + 3.0
    y = jmoe.moe_ffn_local(jnp.asarray(x), jnp.asarray(router),
                           jnp.asarray(g), jnp.asarray(u), jnp.asarray(dn),
                           jmoe.MoEConfig(E, k, cf))
    return np.asarray(y)[:, :E] != 0


def _kept_port(x, router, E, k, cf):
    r = tmoe.route(torch.from_numpy(x), torch.from_numpy(router),
                   tmoe.MoEConfig(E, k, cf))
    kept = np.zeros((x.shape[0], E), bool)
    for t, e, keep in zip(r["stok"].tolist(), r["expert"].tolist(),
                          r["keep"].tolist()):
        kept[t, e] |= keep
    all_ids = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(router),
                               tmoe.MoEConfig(E, k, cf))[1]
    routed = np.zeros_like(kept)
    for t, ids in enumerate(all_ids.tolist()):
        routed[t, ids] = True
    return kept, routed, r["rows"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dropping", [False, True])
def test_kept_and_dropped_copies_are_the_references(arch, dropping):
    """The port keeps and drops exactly the copies the reference does: at
    the config's capacity factor, and at one that drops about a quarter
    of the copies (where a token's output depends on its co-tenants)."""
    cfg = tcb.get_smoke(arch)
    E, k = cfg.n_experts, cfg.top_k
    T = 128
    cf = _dropping_cf(T, k, E) if dropping else cfg.capacity_factor
    x, router = _x(T, cfg.d_model, 3), _router(cfg.d_model, E, 4)
    want = _kept_reference(x, router, E, k, cf)
    kept, routed, rows = _kept_port(x, router, E, k, cf)
    np.testing.assert_array_equal(kept, want)
    n_copies = T * k
    dropped = int(routed.sum()) - int(kept.sum())
    assert int(routed.sum()) == n_copies
    assert int(rows.sum()) == int(kept.sum())
    if dropping:
        assert 0.1 * n_copies < dropped < 0.4 * n_copies, dropped
    else:
        assert dropped < 0.1 * n_copies


def _moe_inputs(arch, T, bits, dist, seed=5):
    cfg = tcb.get_smoke(arch)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    x, router = _x(T, d, seed), _router(d, E, seed + 1)
    stacks = [_stack(E, d, f, seed + 2), _stack(E, d, f, seed + 3),
              _stack(E, f, d, seed + 4)]
    if bits < 16:
        stacks = [_coded(w, bits, dist) for w in stacks]
    return cfg, x, router, stacks


def _reference_ffn(x, router, stacks, cfg, cf, dtype):
    ws = [jlm.materialize(_j(w) if isinstance(w, dict) else jnp.asarray(w),
                          dtype) for w in stacks]
    return np.asarray(jmoe.moe_ffn_local(
        jnp.asarray(x).astype(dtype), jnp.asarray(router), *ws,
        jmoe.MoEConfig(cfg.n_experts, cfg.top_k, cf)).astype(jnp.float32))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,dist", [(16, "gaussian"), (4, "gaussian"),
                                       (8, "gaussian"), (4, "empirical")])
@pytest.mark.parametrize("dropping", [False, True])
def test_moe_ffn_local_matches_reference(arch, dtype, bits, dist, dropping):
    """``moe_ffn_local`` on dense and coded stacks against the reference's
    on the same (dequantized) weights; the port's coded path never
    dequantizes the stack (``qmatmul_experts`` plain version)."""
    T = 96
    cfg, x, router, stacks = _moe_inputs(arch, T, bits, dist)
    E, k = cfg.n_experts, cfg.top_k
    cf = _dropping_cf(T, k, E) if dropping else cfg.capacity_factor
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    want = _reference_ffn(x, router, stacks, cfg, cf, jd)
    ws = [_t(w) if isinstance(w, dict) else torch.from_numpy(w)
          for w in stacks]
    got = tmoe.moe_ffn_local(torch.from_numpy(x).to(td),
                             torch.from_numpy(router), *ws,
                             tmoe.MoEConfig(E, k, cf))
    assert got.dtype == td and tuple(got.shape) == (T, cfg.d_model)
    got = got.to(torch.float32).numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL_F32)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=TOL_BF16_REL * scale)


def test_moe_ffn_reshapes_and_routes_every_row():
    """``moe_ffn`` on (B, S, d) routes all B * S rows together, as the
    reference's (padding rows take capacity)."""
    cfg, x, router, stacks = _moe_inputs("kimi_k2_1t_a32b", 24, 4,
                                         "gaussian")
    mc_j = jmoe.MoEConfig(cfg.n_experts, cfg.top_k, 0.5)
    ws_j = [jlm.materialize(_j(w), jnp.float32) for w in stacks]
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x).reshape(2, 12, -1),
                                   jnp.asarray(router), *ws_j, mc_j))
    got = tmoe.moe_ffn(torch.from_numpy(x).reshape(2, 12, -1),
                       torch.from_numpy(router), *[_t(w) for w in stacks],
                       tmoe.MoEConfig(cfg.n_experts, cfg.top_k, 0.5))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32)


def test_aux_load_balance_loss_matches_reference():
    x, w = _x(64, 32, 7), _router(32, 8, 8)
    want = jmoe.aux_load_balance_loss(jnp.asarray(x), jnp.asarray(w),
                                      jmoe.MoEConfig(8, 2))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(x),
                                     torch.from_numpy(w),
                                     tmoe.MoEConfig(8, 2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the expert matmuls' plain versions ---------------------------------------

EXPERT_CASES = [(4, "gaussian"), (8, "gaussian"), (4, "empirical"),
                (8, "empirical")]


@pytest.mark.parametrize("bits,dist", EXPERT_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_experts_plain_matches_materialize_einsum(bits, dist, dtype):
    """``qmatmul_experts`` / ``qmatmul_lut_experts`` (the plain versions,
    which the wrappers take for CPU tensors) against the reference's
    ``materialize`` of the stack and ``einsum``, every row in use."""
    E, C, K, N = 6, 8, 48, 40
    w = _coded(_stack(E, K, N, 11), bits, dist)
    a = _rng(12).standard_normal((E, C, K)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    want = np.asarray(jnp.einsum(
        "ecd,edf->ecf", jnp.asarray(a).astype(jd),
        jlm.materialize(_j(w), jd)).astype(jnp.float32))
    rows = torch.full((E,), C, dtype=torch.int32)
    wt = _t(w)
    if dist == "empirical":
        got = tops.qmatmul_lut_experts(torch.from_numpy(a).to(td),
                                       wt["q_codes"], wt["q_lut"], rows,
                                       bits=bits, out_dtype=td)
    else:
        got = tops.qmatmul_experts(torch.from_numpy(a).to(td), wt["q_codes"],
                                   wt["q_mu"], wt["q_sigma"], rows,
                                   bits=bits, out_dtype=td)
    assert got.dtype == td and tuple(got.shape) == (E, C, N)
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want,
                                   atol=2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("dist", ["gaussian", "empirical"])
def test_expert_matmul_zeros_unused_rows_under_nan(dist):
    """Trap (d) of the drop rule: experts with no rows (rows 0), some and
    all (rows C); the buffer rows past rows[e] hold NaN, which must never
    be read.  Every output is finite, the unused rows are exactly zero,
    the used ones equal the reference's einsum on those rows; the kernel
    wrappers' own CPU path (per-column (1, N) statistics) too."""
    E, C, K, N = 5, 8, 32, 24
    w = _coded(_stack(E, K, N, 13), 4, dist)
    rows_np = np.array([0, 3, 8, 0, 1], np.int32)
    a = _rng(14).standard_normal((E, C, K)).astype(np.float32)
    used = np.arange(C)[None, :] < rows_np[:, None]
    a_nan = np.where(used[..., None], a, np.nan).astype(np.float32)
    want = np.asarray(jnp.einsum("ecd,edf->ecf",
                                 jnp.asarray(np.where(used[..., None], a, 0)),
                                 jlm.materialize(_j(w), jnp.float32)))
    wt = _t(w)
    rows = torch.from_numpy(rows_np)
    if dist == "empirical":
        got = tops.qmatmul_lut_experts(torch.from_numpy(a_nan),
                                       wt["q_codes"], wt["q_lut"], rows,
                                       bits=4)
        got2 = tops._qmm.qmatmul_lut_experts(
            torch.from_numpy(a_nan), wt["q_codes"], wt["q_lut"], rows,
            bits=4)
    else:
        mu = wt["q_mu"].reshape(1, N).contiguous()
        sg = wt["q_sigma"].reshape(1, N).contiguous()
        got = tops.qmatmul_experts(torch.from_numpy(a_nan), wt["q_codes"],
                                   wt["q_mu"], wt["q_sigma"], rows, bits=4)
        got2 = tops._qmm.qmatmul_experts(torch.from_numpy(a_nan),
                                         wt["q_codes"], mu, sg, rows,
                                         bits=4)
    for g in (got, got2):
        assert torch.isfinite(g).all()
        assert not g.numpy()[~used].any()
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5)


def test_expert_wrappers_check_their_arguments():
    w = _t(_coded(_stack(3, 16, 8, 15), 4))
    a = torch.zeros((3, 8, 16))
    ok = torch.zeros(3, dtype=torch.int32)
    mu = w["q_mu"].reshape(1, 8).contiguous()
    sg = w["q_sigma"].reshape(1, 8).contiguous()
    q = tops._qmm
    for bad in (dict(a=a[0]), dict(rows=ok[:2]), dict(rows=ok.long()),
                dict(w=w["q_codes"][:2]), dict(a=a[:, :, :8])):
        kw = dict(a=a, w=w["q_codes"], rows=ok)
        kw.update(bad)
        with pytest.raises(ValueError):
            q.qmatmul_experts(kw["a"], kw["w"], mu, sg, kw["rows"], bits=4)
    with pytest.raises(ValueError):
        q.qmatmul_lut_experts(a, w["q_codes"], torch.zeros(15), ok, bits=4)


# -- parameters: init, coding, conversion ------------------------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_codes_expert_stacks_layer_by_layer(arch):
    """Trap (a): coding each (E, d, f) layer slice as it is drawn equals
    coding the whole stacked tree afterwards (statistics per (layer,
    column) over all E * d rows); the router stays f32 and dense."""
    cfg = tcb.get_smoke(arch)
    dense = tlm.init_params(3, cfg, device="cpu")
    L, E, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(dense["layers"]["eg"].shape) == (L, E, d, f)
    assert tuple(dense["layers"]["ed"].shape) == (L, E, f, d)
    assert tuple(dense["layers"]["router"].shape) == (L, d, E)
    assert "w_gate" not in dense["layers"]
    for bits in (4, 8):
        direct = tlm.init_params(3, cfg, device="cpu", w_bits=bits)
        via = tlm.quantize_params_for_serving(dense, bits, device="cpu")
        fd, fv = dict(_flat(direct)), dict(_flat(via))
        assert set(fd) == set(fv)
        for key in fd:
            assert torch.equal(fd[key], fv[key]), key
        lay = direct["layers"]
        assert lay["router"].dtype == torch.float32
        assert not tlm.is_qweight(lay["router"])
        assert tuple(lay["eg"]["q_mu"].shape) == (L, 1, 1, f)
        assert tuple(lay["ed"]["q_codes"].shape) == \
            ((L, E, f, d // 2) if bits == 4 else (L, E, f, d))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_quantized_moe_tree_matches_reference_layout(arch):
    """The reference's W4 MoE tree carried across: the codes equal the
    port's own coding of the same dense tree (but at bin edges), the
    statistics agree, the layout is the same."""
    cfg_j = jcb.get_smoke(arch)
    p = jmodel.init(jax.random.PRNGKey(0), cfg_j)
    q = jmodel.quantize_for_serving(p, 4)
    dense_t = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")
    mine = tlm.quantize_params_for_serving(dense_t, 4, device="cpu")
    theirs = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, q),
                                       device="cpu")
    for name in ("eg", "eu", "ed"):
        a, b = mine["layers"][name], theirs["layers"][name]
        assert set(a) == set(b) == {"q_codes", "q_mu", "q_sigma"}
        for key in a:
            assert a[key].shape == b[key].shape and a[key].dtype == \
                b[key].dtype, (name, key)
        np.testing.assert_allclose(a["q_mu"].numpy(), b["q_mu"].numpy(),
                                   atol=1e-7)
        np.testing.assert_allclose(a["q_sigma"].numpy(),
                                   b["q_sigma"].numpy(), rtol=1e-5)
        differ = (a["q_codes"] != b["q_codes"]).float().mean()
        assert differ <= 1e-3, (name, float(differ))
    assert not tlm.is_qweight(mine["layers"]["router"])


def test_params_from_numpy_keeps_router_f32():
    cfg = jcb.get_smoke("kimi_k2_1t_a32b")
    q = jmodel.quantize_for_serving(jmodel.init(jax.random.PRNGKey(1), cfg), 4)
    tree = jax.tree_util.tree_map(np.asarray, q)
    pt = convert.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    lay = pt["layers"]
    assert lay["router"].dtype == torch.float32
    np.testing.assert_array_equal(lay["router"].numpy(),
                                  tree["layers"]["router"])
    assert lay["attn_norm"].dtype == torch.bfloat16
    for name in ("eg", "eu", "ed"):
        assert lay[name]["q_codes"].ndim == 4
        assert lay[name]["q_codes"].dtype == torch.uint8
        assert lay[name]["q_mu"].dtype == torch.float32
    back = convert.train_state_to_numpy(pt)
    np.testing.assert_array_equal(back["layers"]["eg"]["q_codes"],
                                  tree["layers"]["eg"]["q_codes"])


def _count_codings(monkeypatch):
    """Count the blocks the empirical coding codes (its calls of the
    quantizer)."""
    calls = []
    orig = tlm.Q.kquantile_quantize

    def counted(w, m, k, **kw):
        calls.append(tuple(w.shape))
        return orig(w, m, k, **kw)

    monkeypatch.setattr(tlm.Q, "kquantile_quantize", counted)
    return calls


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block,n_blocks", [(1, 8), (16 * 32, 8),
                                            (3 * 16 * 32, 3)])
def test_streamed_empirical_coding_equals_whole_slice_coding(
        bits, block, n_blocks, monkeypatch):
    """A (1, E, d, f) expert slice is fitted whole and coded a block of
    experts at a time (``EMPIRICAL_BLOCK_ELEMS`` cut to one row, one
    expert, three experts: blocks of 3, 3 and 2 of the 8): codes and
    codebook equal coding the slice in one call, bit for bit."""
    w = torch.from_numpy((_rng(40 + bits).standard_normal((1, 8, 16, 32))
                          * 0.05).astype(np.float32))
    k = 2 ** bits
    m = tlm.EmpiricalModel.fit(w[0])
    codes = tlm.Q.kquantile_quantize(w[0], m, k)
    want = tlm.packing.pack_int4(codes) if bits == 4 \
        else (codes - 128).to(torch.int8)
    monkeypatch.setattr(tlm, "EMPIRICAL_BLOCK_ELEMS", block)
    calls = _count_codings(monkeypatch)
    got = tlm._quantize_leaf(w, bits, True, True, "empirical")
    assert len(calls) == n_blocks
    assert max(c[0] for c in calls) == max(1, block // (16 * 32))
    assert got["q_codes"].dtype == want.dtype
    assert torch.equal(got["q_codes"][0], want)
    assert torch.equal(got["q_lut"][0], m.level_values(k))


@pytest.mark.parametrize("bits", [4, 8])
def test_streamed_empirical_coding_matches_reference(bits, monkeypatch):
    """A stacked (2, E, d, f) expert leaf coded one expert at a time
    against the reference's ``_quantize_leaf_empirical`` (each layer
    coded whole): codes bit-equal, codebook levels within 4 ulps (the
    bounds of test_torch_kquantile)."""
    w = (_rng(50 + bits).standard_normal((2, 8, 16, 32)) * 0.05).astype(
        np.float32)
    monkeypatch.setattr(tlm, "EMPIRICAL_BLOCK_ELEMS", 16 * 32)
    calls = _count_codings(monkeypatch)
    qt = tlm._quantize_leaf_empirical(torch.from_numpy(w), bits, True)
    assert len(calls) == 2 * 8
    qj = jlm._quantize_leaf_empirical(jnp.asarray(w), bits, True)
    np.testing.assert_array_equal(qt["q_codes"].numpy(),
                                  np.asarray(qj["q_codes"]))
    lj = np.asarray(qj["q_lut"])
    assert tuple(qt["q_lut"].shape) == lj.shape == (2, 2 ** bits)
    np.testing.assert_allclose(qt["q_lut"].numpy(), lj, rtol=0,
                               atol=4 * np.spacing(np.abs(lj).max()))


def test_streamed_empirical_kimi_engine_matches_reference(monkeypatch):
    """kimi_k2 smoke coded W4 empirical with the block cut to one expert
    (the embedding 64 rows a block, the head 8): the codes equal the
    reference's ``quantize_for_serving(dist="empirical")`` and the paged
    kv8 engine gives the reference engine's greedy tokens (capacity factor
    64, as test_torch_moe_engine)."""
    from repro.serve import engine as jeng
    from test_torch_moe_engine import (ENGINES, JOPTS, NO_DROP, TOPTS,
                                       _cfgs, _prompts, _reqs, _tok)
    arch = "kimi_k2_1t_a32b"
    cj, ct = _cfgs(arch, NO_DROP)
    pj = jmodel.init(jax.random.PRNGKey(0), cj)
    dense = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                      device="cpu")
    pj = jmodel.quantize_for_serving(pj, 4, dist="empirical")
    monkeypatch.setattr(tlm, "EMPIRICAL_BLOCK_ELEMS", ct.d_model * ct.d_ff)
    calls = _count_codings(monkeypatch)
    pt = tmodel.quantize_for_serving(dense, 4, dist="empirical",
                                     device="cpu")
    # per layer: 4 projections of one block and 3 stacks of 8 experts;
    # the embedding's 512 rows and the head's 64 in 8 blocks each
    assert len(calls) == ct.n_layers * (4 + 3 * 8) + 2 * 8
    for name in ("eg", "eu", "ed", "wq"):
        np.testing.assert_array_equal(
            pt["layers"][name]["q_codes"].numpy(),
            np.asarray(pj["layers"][name]["q_codes"]), err_msg=name)
    prompts = _prompts([9, 5, 13, 7], seed=4)
    ec = dict(max_slots=3, max_len=48, prefill_batch=2, min_bucket=8,
              **ENGINES["paged_kv8"])
    ej = jeng.Engine(pj, cj, JOPTS, jeng.EngineConfig(**ec))
    et = teng.Engine(pt, ct, TOPTS, teng.EngineConfig(**ec), device="cpu")
    oj = ej.generate(_reqs(jeng, prompts, 6))
    ot = et.generate(_reqs(teng, prompts, 6))
    assert _tok(ot) == _tok(oj)


def test_codec_cuts_a_group_past_the_kernel_limit():
    """A layer slice (1, E, d, f) of an expert stack with per-column
    statistics is one codec group of E * d * f elements; past 2^31 (the
    kernels' limit, here cut to 64) it becomes E groups of (d, f) with the
    statistics expanded, and the codes do not change."""
    w = torch.randn(1, 4, 8, 6)
    mu, sg = w.mean(dim=(1, 2), keepdim=True), w.std(dim=(1, 2),
                                                    keepdim=True)
    G, R, m3, _ = tops.codec_layout(tuple(w.shape), 6, mu, sg)
    assert (G, R) == (1, 32)
    want = tops.quantize_weights(w, mu, sg, bits=4)
    from repro_torch.kernels import kquantile as tkq
    old = tkq.MAX_GROUP
    try:
        tkq.MAX_GROUP = 64
        G, R, m3, _ = tops.codec_layout(tuple(w.shape), 6, mu, sg)
        assert (G, R) == (4, 8) and tuple(m3.shape) == (4, 1, 6)
        assert torch.equal(tops.quantize_weights(w, mu, sg, bits=4), want)
        back = tops.dequantize_weights(want, mu, sg, bits=4)
    finally:
        tkq.MAX_GROUP = old
    assert torch.equal(back, tops.dequantize_weights(want, mu, sg, bits=4))


# -- the registry -------------------------------------------------------------

def test_every_reference_arch_is_registered():
    assert tcb.ARCH_IDS == jcb.ARCH_IDS
    for arch in jcb.ARCH_IDS:
        for get_j, get_t in ((jcb.get, tcb.get),
                             (jcb.get_smoke, tcb.get_smoke)):
            assert dataclasses.asdict(get_t(arch)) == \
                dataclasses.asdict(get_j(arch)), arch
    assert set(tcb.entries()) == set(jcb.entries())


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_families_not_ported_raise_naming_the_family(arch):
    """audio and vlm, once not ported, serve the closed batch only:
    ``model.init`` draws them, ``generate`` runs them, the engine refuses
    them with the reference's ValueError naming the family, and they have
    no paged cache (as ``test_state_space_families_serve_the_closed_batch_
    only`` checks ssm and hybrid)."""
    cfg = tcb.get_smoke(arch)
    pt = tmodel.init(0, cfg, device="cpu", w_bits=4)
    stack = "dec_layers" if cfg.family == "audio" else "layers"
    assert tlm.is_qweight(pt[stack]["wq"])
    with pytest.raises(ValueError, match=f"decoder-only KV families; got "
                                         f"{cfg.family}"):
        teng.Engine(pt, cfg, tlm.ModelOpts(compute_dtype=torch.float32),
                    teng.EngineConfig(), device="cpu")
    out = tserve.generate(pt, cfg, tlm.ModelOpts(compute_dtype=torch.float32),
                          tserve.ServeConfig(),
                          torch.zeros((1, 2), dtype=torch.int32), 3)
    assert tuple(out.shape) == (1, 3)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    assert not tmodel.supports_paged_cache(cfg)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_state_space_families_serve_the_closed_batch_only(arch):
    """ssm and hybrid are ported for serving: ``model.init`` draws them,
    ``generate`` runs them, the engine refuses them with the reference's
    ValueError, and they have no paged cache."""
    cfg = tcb.get_smoke(arch)
    pt = tmodel.init(0, cfg, device="cpu", w_bits=4)
    assert tlm.is_qweight(pt["layers"]["in_proj"])
    with pytest.raises(ValueError, match="decoder-only KV families"):
        teng.Engine(pt, cfg, tlm.ModelOpts(compute_dtype=torch.float32),
                    teng.EngineConfig(), device="cpu")
    out = tserve.generate(pt, cfg, tlm.ModelOpts(compute_dtype=torch.float32),
                          tserve.ServeConfig(),
                          torch.zeros((1, 2), dtype=torch.int32), 3)
    assert tuple(out.shape) == (1, 3)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    assert not tmodel.supports_paged_cache(cfg)


def test_an_unknown_family_gets_the_reference_engine_error():
    """A ported family the engine does not serve keeps the reference's
    ValueError wording (as ssm and hybrid do, above)."""
    cfg = tcb.get_smoke("granite_3_8b")
    pt = tlm.init_params(0, cfg, device="cpu")
    saved = tmodel.PORTED_FAMILIES
    try:
        tmodel.PORTED_FAMILIES = saved + ("rnn",)
        with pytest.raises(ValueError, match="decoder-only KV families"):
            teng.Engine(pt, dataclasses.replace(cfg, family="rnn"),
                        tlm.ModelOpts(), teng.EngineConfig(), device="cpu")
    finally:
        tmodel.PORTED_FAMILIES = saved
