"""PyTorch port vs JAX reference: chunked (online-softmax) attention.

``attention.chunked_attention`` against the reference's at small sizes
(GQA, causal and bidirectional, a sliding window across chunk edges, a
logit cap, fully masked rows, the single-chunk fallback), then the three
model sites that switch to it from S = ``attn_chunked_min_len`` on (the
decoder's ``_attn_block``, zamba2's shared block, whisper's encoder and
decoder self-attention) at the smoke configs with the switch lowered to 32
rows and chunks of 16, and the training loss and gradients through it.
The same numpy inputs go through both; f32 on both sides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.lm import ModelOpts as JOpts

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import base as tcb
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel

from test_torch_lm import TOL_LOGITS, TOL_LOGITS_KVQ, _compare_kv, \
    _jax_cache_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one attention output, f32, from the same inputs: the two frameworks sum
# each chunk's products in other orders (einsum vs matmul) and take other
# exp implementations; stated relative to max(1, |reference|)
TOL_ATTN = 2e-6
# the port's chunked against its own materialized attention: the same
# softmax summed chunk by chunk (relative to max(1, |whole|))
TOL_CHUNKED_VS_WHOLE = 1e-5
# loss and gradients at the smoke configs, as test_torch_train's
TOL_LOSS_REL = 1e-5
TOL_GRAD_REL = 1e-4

MIN_LEN, KV_CHUNK = 32, 16


def _qkv(B, Sq, Sk, H, KV, D, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32) for s in
                 ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


ATTN_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, cap, q offset, kv_chunk)
    (2, 24, 24, 4, 2, 8, True, None, None, 0, 8),      # GQA, causal
    (1, 24, 24, 4, 4, 8, False, None, None, 0, 8),     # bidirectional
    (2, 32, 32, 4, 2, 8, True, 5, None, 0, 8),         # window across edges
    (2, 24, 24, 6, 2, 8, True, None, 5.0, 0, 8),       # logit cap
    (2, 16, 24, 4, 2, 8, True, 9, None, -6, 8),        # rows fully masked
    (1, 20, 20, 4, 2, 8, True, None, 5.0, 0, 8),       # 20 % 8: one chunk
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_matches_reference(case):
    B, Sq, Sk, H, KV, D, causal, window, cap, off, kc = case
    q, k, v = _qkv(B, Sq, Sk, H, KV, D)
    q_pos = np.arange(Sq, dtype=np.int32) + off
    k_pos = np.arange(Sk, dtype=np.int32)
    pj = jattn.AttnParams(window=window, logit_cap=cap, causal=causal)
    pt = tattn.AttnParams(window=window, logit_cap=cap, causal=causal)
    want = np.asarray(jattn.chunked_attention(
        *(jnp.asarray(x) for x in (q, k, v, q_pos, k_pos)), pj, kv_chunk=kc))
    got = tattn.chunked_attention(
        *(torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)), pt,
        kv_chunk=kc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Sq, H, D)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL_ATTN * scale)
    if off < 0:                                # rows with no visible key
        dead = q_pos < 0
        assert (got.numpy()[:, dead] == 0).all() and \
            (want[:, dead] == 0).all()
    else:                                      # = materialized attention
        whole = tattn.full_attention(
            *(torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)), pt)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=TOL_CHUNKED_VS_WHOLE * scale)


def test_chunked_attention_bf16_and_its_gradient():
    """bf16 inputs come back bf16 (f32 inside, as the reference); the
    gradient of every input through the chunk loop against jax.grad."""
    B, S, H, KV, D = 2, 24, 4, 2, 8
    q, k, v = _qkv(B, S, S, H, KV, D, seed=1)
    pos = np.arange(S, dtype=np.int32)
    pj = jattn.AttnParams(window=7, logit_cap=5.0)
    pt = tattn.AttnParams(window=7, logit_cap=5.0)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    got = tattn.chunked_attention(qb, torch.from_numpy(k).to(torch.bfloat16),
                                  torch.from_numpy(v).to(torch.bfloat16),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(pos), pt, kv_chunk=8)
    want = jattn.chunked_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(pos), pj,
        kv_chunk=8)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the f32 output on each side (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -8)

    g = np.random.default_rng(2).standard_normal((B, S, H, D)).astype(
        np.float32)
    gj = jax.grad(lambda a, b, c: jnp.sum(jattn.chunked_attention(
        a, b, c, jnp.asarray(pos), jnp.asarray(pos), pj, kv_chunk=8) * g),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tattn.chunked_attention(*xs, torch.from_numpy(pos),
                                  torch.from_numpy(pos), pt, kv_chunk=8)
    gt = torch.autograd.grad((out * torch.from_numpy(g)).sum(), xs)
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        # f32 backward through exp and the running rescale: 1e-5 of the
        # largest gradient
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))


# -- the three model sites -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's f32 init, carried across (dense weights: the
    reference codes a smoke tree in ~14 s of eager JAX)."""
    p = jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke(arch))
    return p, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _opts(kv_bits=16, min_len=MIN_LEN):
    jo = JOpts(compute_dtype=jnp.float32, remat=False, kv_bits=kv_bits,
               attn_chunked_min_len=min_len, kv_chunk=KV_CHUNK)
    to = tlm.ModelOpts(compute_dtype=torch.float32, kv_bits=kv_bits,
                       attn_chunked_min_len=min_len, kv_chunk=KV_CHUNK)
    return jo, to


def _batch(cfg, S, seed=0):
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab, size=(2, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = r.standard_normal((2, S, cfg.d_model)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


_jprefill = jax.jit(jmodel.prefill, static_argnums=(1, 2))

SITES = [("granite_3_8b", 8, 48), ("gemma2_9b", 8, 64),
         ("zamba2_2_7b", 16, 48), ("whisper_base", 16, 48)]


@pytest.mark.parametrize("arch,kv_bits,S", SITES)
def test_model_sites_attend_in_chunks_as_the_reference(arch, kv_bits, S):
    """Prefill at S >= attn_chunked_min_len (32) in chunks of 16 rows:
    gemma2's 32-row window crosses chunk edges and its logit cap acts in
    each chunk; zamba2's shared block; whisper's bidirectional encoder and
    causal decoder.  Last logits, the caches (KV codes at kv8) and the
    greedy tokens against the reference's, and against the port's own
    materialized attention."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    pj, pt = _params(arch)
    jo, to = _opts(kv_bits)
    bj, bt = _batch(cfg_t, S)
    lj, cj = _jprefill(pj, cfg_j, jo, bj)
    lt, ct = tmodel.prefill(pt, cfg_t, to, bt)
    tol = TOL_LOGITS if kv_bits == 16 else TOL_LOGITS_KVQ
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, atol=tol * max(
        1.0, float(np.abs(lj).max())))
    np.testing.assert_array_equal(lt.numpy().argmax(-1), lj.argmax(-1))
    if kv_bits < 16:
        _compare_kv(_jax_cache_np(cj), convert.cache_to_numpy(ct), kv_bits)
    else:
        for name, a in _jax_cache_np(cj).items():
            b = convert.cache_to_numpy(ct)[name]
            # dense caches: the TOL_LOGITS bound of O(1) values
            np.testing.assert_allclose(b, a, atol=TOL_LOGITS * max(
                1.0, float(np.abs(a).max())), err_msg=name)
    # and the port's own materialized attention on the same inputs
    whole, _ = tmodel.prefill(pt, cfg_t, dataclasses.replace(
        to, attn_chunked_min_len=1 << 30), bt)
    np.testing.assert_allclose(lt.numpy(), whole.numpy(), rtol=0,
                               atol=TOL_CHUNKED_VS_WHOLE * max(
                                   1.0, float(whole.abs().max())))


def test_forward_train_through_chunked_attention_matches_reference():
    """The loss and the gradient of every leaf at S = 48 >= 32 (three
    chunks of 16 rows, causal) against the reference's jax.grad, the
    port's per-layer recompute (remat) on."""
    cfg_j, cfg_t = (c.get_smoke("granite_3_8b") for c in (jcb, tcb))
    pj, _ = _params("granite_3_8b")
    r = np.random.default_rng(3)
    batch = {"tokens": r.integers(0, cfg_j.vocab, (2, 48)).astype(np.int32),
             "targets": r.integers(0, cfg_j.vocab, (2, 48)).astype(np.int32)}
    jo = dataclasses.replace(_opts()[0], ce_chunk=16)
    loss_j, g_j = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(
        p, cfg_j, jo, b)))(pj, jax.tree_util.tree_map(jnp.asarray, batch))
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   device="cpu")
    leaves = list(tree_lib.leaves_with_paths(pt))
    for _, t in leaves:
        t.requires_grad_(True)
    to = dataclasses.replace(_opts()[1], ce_chunk=16, remat=True)
    loss_t = tmodel.loss_fn(pt, cfg_t, to,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss_t, [t for _, t in leaves])
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=TOL_LOSS_REL)
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
              for kp, v in jax.tree_util.tree_flatten_with_path(g_j)[0]}
    for (p, _), g in zip(leaves, grads):
        want = flat_j[p]
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=(
            TOL_GRAD_REL * float(np.abs(want).max()) + 1e-9), err_msg=p)
