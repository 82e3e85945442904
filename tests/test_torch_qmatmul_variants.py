"""PyTorch port vs JAX reference: the codebook (``qmatmul_lut``) and
int8-activation (``qmatmul_a8``) matmuls.

The port's plain versions (what its wrappers compute for CPU tensors, and
what the CUDA kernels are held against on the card) are compared with the
reference's oracles (``repro.kernels.ref``), its Pallas kernels in
interpret mode, and the serving matmuls of its model (``lm.mm`` /
``lm.mm_a``), on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import qmatmul as jqmm
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models.lm import ModelOpts as JOpts

from repro_torch.core import activations as tact
from repro_torch.core import packing as tpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MKN = [(8, 64, 32), (48, 384, 192), (33, 520, 96), (5, 200, 130), (1, 16, 2)]


def _codes(K, N, bits, seed):
    """Random stored codes of a (K, N) weight (packed at 4 bits)."""
    r = np.random.default_rng(seed)
    if bits == 4:
        c = r.integers(0, 16, size=(K, N))
        return ((c[:, 0::2] & 0xF) | ((c[:, 1::2] & 0xF) << 4)) \
            .astype(np.uint8)
    return r.integers(-128, 128, size=(K, N)).astype(np.int8)


def _gaussian(K, N, bits, seed):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((K, N)) * 0.03).astype(np.float32)
    mu = w.mean(axis=0, keepdims=True)
    sd = w.std(axis=0, keepdims=True)
    wp = np.asarray(jops.quantize_weights(
        jnp.asarray(w)[None], jnp.asarray(mu)[None], jnp.asarray(sd)[None],
        bits=bits, use_pallas=False)[0])
    return wp, mu, sd


def _lut(N, bits, per_col, seed):
    """Sorted (k, N) per-column or (k,) per-tensor levels."""
    r = np.random.default_rng(seed)
    k = 2 ** bits
    shape = (k, N) if per_col else (k,)
    return np.sort(r.standard_normal(shape) * 0.03, axis=0).astype(np.float32)


def _t(*arrs):
    return [torch.from_numpy(np.array(x)) for x in arrs]


# -- qmatmul_lut --------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_col", [True, False])
@pytest.mark.parametrize("mkn", MKN)
def test_lut_plain_matches_reference_oracle(bits, per_col, mkn):
    M, K, N = mkn
    r = np.random.default_rng(M + K)
    a = (r.standard_normal((M, K)) * 0.1).astype(np.float32)
    wp, lut = _codes(K, N, bits, seed=K), _lut(N, bits, per_col, seed=N)
    lut_kn = lut if per_col else np.broadcast_to(lut[:, None],
                                                 (2 ** bits, N))
    want = np.asarray(jref.qmatmul_lut_ref(jnp.asarray(a), jnp.asarray(wp),
                                           jnp.asarray(lut_kn), bits))
    ta, twp, tlut = _t(a, wp, lut)
    got = tqmm.qmatmul_lut(ta, twp, tlut, bits=bits)          # CPU -> plain
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    # identical levels (the codebook is an input); f32 sums in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    assert torch.equal(got, tqmm.qmatmul_lut_plain(ta, twp, tlut, bits=bits))
    # the port's own oracle takes the per-tensor codebook unexpanded
    np.testing.assert_allclose(
        tref.qmatmul_lut_ref(ta, twp, tlut, bits).numpy(), got.numpy(),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn,blocks", [
    ((48, 384, 192), (32, 512, 512)),
    ((33, 520, 96), (16, 64, 32)),         # ragged final tile on every axis
    ((16, 256, 128), (None, None, None)),
])
def test_lut_plain_matches_reference_kernel_interpreted(bits, mkn, blocks):
    M, K, N = mkn
    bm, bk, bn = blocks
    r = np.random.default_rng(7)
    a = (r.standard_normal((M, K)) * 0.1).astype(np.float32)
    wp, lut = _codes(K, N, bits, seed=8), _lut(N, bits, True, seed=9)
    out_k = np.asarray(jqmm.qmatmul_lut(jnp.asarray(a), jnp.asarray(wp),
                                        jnp.asarray(lut), bits=bits, bm=bm,
                                        bk=bk, bn=bn, interpret=True))
    got = tqmm.qmatmul_lut(*_t(a, wp, lut), bits=bits).numpy()
    # the same f32 levels and products; tile-wise vs whole f32 sums
    np.testing.assert_allclose(got, out_k, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
def test_lut_bf16_matches_reference_serving_matmul(bits):
    """bf16 activations: the levels are rounded to bf16 first, as the
    reference's ``lm.mm`` does through ``materialize(w, x.dtype)``."""
    M, K, N = 16, 128, 64
    r = np.random.default_rng(10)
    a = (r.standard_normal((M, K)) * 0.5).astype(np.float32)
    wp, lut = _codes(K, N, bits, seed=11), _lut(N, bits, False, seed=12)
    want = np.asarray(jlm.mm(jnp.asarray(a).astype(jnp.bfloat16),
                             {"q_codes": jnp.asarray(wp),
                              "q_lut": jnp.asarray(lut)})
                      .astype(jnp.float32))
    ta, twp, tlut = _t(a, wp, lut)
    got = tlm.mm(ta.to(torch.bfloat16), {"q_codes": twp, "q_lut": tlut})
    assert got.dtype == torch.bfloat16
    # f32 sums of the same bf16 products, each rounded to bf16: one ulp
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8,
                               rtol=2 ** -7)
    plain = tops.qmatmul_lut(ta.to(torch.bfloat16), twp, tlut, bits=bits,
                             out_dtype=torch.bfloat16, use_kernel=False)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bits", [4, 8])
def test_lut_ops_wrapper_leading_shape(bits):
    B, S, K, N = 2, 3, 64, 32
    r = np.random.default_rng(13)
    a = (r.standard_normal((B, S, K)) * 0.1).astype(np.float32)
    wp, lut = _codes(K, N, bits, seed=14), _lut(N, bits, False, seed=15)
    ta, twp, tlut = _t(a, wp, lut)
    got = tops.qmatmul_lut(ta, twp, tlut, bits=bits)
    assert tuple(got.shape) == (B, S, N)
    want = tqmm.qmatmul_lut(ta.reshape(B * S, K), twp, tlut, bits=bits)
    assert torch.equal(got.reshape(B * S, N), want)


# -- qmatmul_a8 ---------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", MKN)
def test_a8_plain_matches_reference_oracle_scalar_scale(bits, mkn):
    M, K, N = mkn
    r = np.random.default_rng(M * 3 + K)
    x = (r.standard_normal((M, K)) * 2.0).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127.0)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    wp, mu, sd = _gaussian(K, N, bits, seed=K + N)
    want = np.asarray(jref.qmatmul_a8_ref(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(wp),
        jnp.asarray(mu), jnp.asarray(sd), bits))
    tc, twp, tmu, tsd = _t(codes, wp, mu, sd)
    tscale = torch.tensor(scale)
    got = tqmm.qmatmul_a8(tc, tscale, twp, tmu, tsd, bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    # identical codes and scale; level tables within 5e-7; f32 sums in
    # another order
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-5)
    assert torch.equal(got, tqmm.qmatmul_a8_plain(tc, tscale, twp, tmu, tsd,
                                                  bits=bits))


@pytest.mark.parametrize("bits", [4, 8])
def test_a8_matches_reference_kernel_interpreted(bits):
    """The TPU kernel rounds the activation and the weight tile to bf16
    before its product; the port follows the reference's oracle and engine
    and keeps both in f32: the two differ by bf16 rounding, ~2^-8
    relative."""
    M, K, N = 16, 256, 128
    r = np.random.default_rng(20)
    x = (r.standard_normal((M, K))).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127.0)
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    wp, mu, sd = _gaussian(K, N, bits, seed=21)
    out_k = np.asarray(jqmm.qmatmul_a8(jnp.asarray(codes), jnp.asarray(scale),
                                       jnp.asarray(wp), jnp.asarray(mu),
                                       jnp.asarray(sd), bits=bits,
                                       interpret=True))
    got = tqmm.qmatmul_a8(*_t(codes), torch.tensor(scale), *_t(wp, mu, sd),
                          bits=bits).numpy()
    np.testing.assert_allclose(got, out_k, rtol=0,
                               atol=2.0 ** -7 * np.abs(out_k).max())
    want = np.asarray(jref.qmatmul_a8_ref(
        jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(wp),
        jnp.asarray(mu), jnp.asarray(sd), bits))
    # and against the f32 oracle the port follows: summation order only
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_a8_per_token_matches_reference_mm_a(bits, a_bits, x_dtype):
    """The engine's A8 matmul: per-token absmax codes (core/activations.py)
    then ``qmatmul_a8`` with the (M, 1) scales, against the reference's
    ``lm.mm_a``."""
    B, S, K, N = 2, 5, 96, 48
    r = np.random.default_rng(30 + bits + a_bits)
    x = (r.standard_normal((B, S, K)) * 1.5).astype(np.float32)
    wp, mu, sd = _gaussian(K, N, bits, seed=31)
    jdt, tdt = getattr(jnp, x_dtype), getattr(torch, x_dtype)
    jo = JOpts(compute_dtype=jdt, serve_a_bits=a_bits)
    want = np.asarray(jlm.mm_a(jnp.asarray(x).astype(jdt),
                               {"q_codes": jnp.asarray(wp),
                                "q_mu": jnp.asarray(mu),
                                "q_sigma": jnp.asarray(sd)}, jo)
                      .astype(jnp.float32))
    tx, twp, tmu, tsd = _t(x, wp, mu, sd)
    to = tlm.ModelOpts(compute_dtype=tdt, serve_a_bits=a_bits)
    got = tlm.mm_a(tx.to(tdt), {"q_codes": twp, "q_mu": tmu, "q_sigma": tsd},
                   to)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, N)
    # same codes and scales (test_torch_kquantile pins the codec bit for
    # bit); f32 sums in another order, then the cast to x's dtype
    ulp = 2.0 ** -8 if x_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ulp,
                               atol=ulp * np.abs(want).max())
    # the ops route, spelled out
    codes, scale = tact.quant_act(tx.to(tdt), a_bits,
                                  tact.act_scale(tx.to(tdt), a_bits, axis=-1))
    direct = tops.qmatmul_a8(codes, scale, twp, tmu, tsd, bits=bits,
                             out_dtype=tdt)
    assert torch.equal(got, direct)
    # a dense weight falls through to the plain matmul, as in the reference
    dense = torch.from_numpy(
        (r.standard_normal((K, N)) * 0.03).astype(np.float32))
    assert torch.equal(tlm.mm_a(tx, dense, to), tlm.mm(tx, dense))


@pytest.mark.parametrize("k", [16, 256])
def test_level_split_sums_to_the_level_table(k):
    """The tensor-core ``qmatmul_a8`` multiplies int8 codes by three bf16
    parts of each level: h + d + l reproduces the f32 table exactly (each
    remainder is exact in f32 and three 8-bit significands cover 24), so
    no residual is left for the kernel to drop."""
    parts = tref.level_split(k)
    assert parts.dtype == torch.bfloat16 and tuple(parts.shape) == (3, k)
    table = tref.level_table(k)
    p64 = parts.to(torch.float64)
    assert torch.equal(p64.sum(0), table.to(torch.float64))
    # and the f32 sum in the kernel's order, small parts first
    assert torch.equal(parts[2].float() + parts[1].float() + parts[0].float(),
                       table)
    # each part is the bf16 rounding of what the earlier ones leave
    assert torch.equal(parts[0], table.to(torch.bfloat16))
    assert torch.equal(parts[1], (table - parts[0].float()).to(torch.bfloat16))
    # an int8 code times a part is exact in f32
    c = torch.arange(-128, 128, dtype=torch.float64)[:, None]
    assert torch.equal((c * p64[0]).to(torch.float32).to(torch.float64),
                       c * p64[0])


# Largest |factored - plain| read over the cases below (outputs up to 8.5):
# 3.8e-6.  The plain version rounds code * scale and each level to f32
# before an f32 sum; the factored form applies scale, mu and sigma after
# exact partial products.
TOL_A8_FACTORED = 5e-4


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 16, 256])
@pytest.mark.parametrize("per_row", [True, False])
def test_a8_factored_three_part_sum_matches_plain(bits, M, per_row):
    """The kernel's arithmetic, emulated on the CPU in f32:
    ``s * (mu * R + sigma * (c @ h[q] + (c @ l[q] + c @ d[q])))`` with
    R = sum(c), the level parts from ``ref.level_split``.  It agrees with
    ``qmatmul_a8_plain`` (f32 ``code * scale`` against f32 levels) within
    the card check's ``TOL_QMM_A8``; codes include -128 and 127."""
    K, N = 4096, 512
    k = 2 ** bits
    r = np.random.default_rng(100 * bits + M)
    x = torch.from_numpy(r.standard_normal((M, K)).astype(np.float32))
    scale = tact.act_scale(x, 8, axis=-1) if per_row else \
        tact.act_scale(x, 8).reshape(1)
    codes, _ = tact.quant_act(x, 8, scale)
    codes[0, :4] = torch.tensor([-128, 127, -128, 127], dtype=torch.int8)
    wp, mu, sd = _gaussian(K, N, bits, seed=7 * M + bits)
    tc, twp, tmu, tsd = _t(codes.numpy(), wp, mu, sd)
    q = (tpack.unpack_int4(twp) if bits == 4 else twp).long() \
        + tref.code_offset(k)
    h, d, l = (part.float()[q] for part in tref.level_split(k))
    c = tc.float()
    acc_dl = c @ l + c @ d
    acc_h = c @ h
    R = c.sum(1, keepdim=True)
    got = scale * (tmu * R + tsd * (acc_h + acc_dl))
    want = tqmm.qmatmul_a8_plain(tc, scale, twp, tmu, tsd, bits=bits)
    err = (got - want).abs().max().item()
    assert err <= TOL_A8_FACTORED, err


def test_a8_rejects_what_the_kernel_does_not_take():
    wp, mu, sd = _gaussian(16, 8, 4, seed=40)
    twp, tmu, tsd = _t(wp, mu, sd)
    codes = torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError):                      # codes not int8
        tqmm.qmatmul_a8(codes.float(), torch.ones(1), twp, tmu, tsd, bits=4)
    with pytest.raises(ValueError):                      # scale shape
        tqmm.qmatmul_a8(codes, torch.ones(3, 1), twp, tmu, tsd, bits=4)
    with pytest.raises(ValueError):                      # K mismatch
        tqmm.qmatmul_a8(codes[:, :8], torch.ones(1), twp, tmu, tsd, bits=4)
    with pytest.raises(ValueError):                      # lut shape
        tqmm.qmatmul_lut(torch.zeros(4, 16), twp, torch.zeros(8), bits=4)
    with pytest.raises(TypeError):
        tqmm.qmatmul_lut(torch.zeros(4, 16, dtype=torch.float64), twp,
                         torch.zeros(16), bits=4)
    with pytest.raises(TypeError):
        tqmm.qmatmul_lut(torch.zeros(4, 16), twp, torch.zeros(16), bits=4,
                         out_dtype=torch.float16)


def test_launch_counters_count_only_kernel_launches():
    before = tops.launch_counts()
    wp, mu, sd = _gaussian(16, 8, 4, seed=41)
    twp, tmu, tsd = _t(wp, mu, sd)
    tqmm.qmatmul_a8(torch.ones((2, 16), dtype=torch.int8), torch.ones(1),
                    twp, tmu, tsd, bits=4)
    tqmm.qmatmul_lut(torch.ones(2, 16), twp, torch.zeros(16), bits=4)
    assert tops.launch_counts() == before
    assert {"qmatmul_a8", "qmatmul_lut"} <= set(before)


# -- qmatmul_lut's warpgroup body, emulated on the CPU ------------------------
#
# For bf16 activations the kernel multiplies by a per-block table holding
# bf16(lut[c]) (one codebook) or bf16(lut[c, n]) (per column) and sums in the
# order of csrc/qmatmul.cu's qmatmul_wg_kernel: 16-row steps from zero inside
# each split of K, then the splits left to right.

# chip_smoke.py's TOL_QMM_LUT, the bound the card check holds the kernel to
TOL_QMM_LUT = 5e-4


def _lut_table(lut, N):
    """The kernel's (k, N) table: each entry rounded to nearest even bf16."""
    t = torch.from_numpy(lut)
    if t.ndim == 1:
        t = t[:, None].expand(t.shape[0], N)
    return t.to(torch.bfloat16)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_col", [True, False])
def test_lut_kernel_table_is_the_plain_bf16_weight(bits, per_col):
    """Every code x column of the kernel's table equals, bit for bit, the
    weight the plain version multiplies for bf16 activations."""
    k, N = 2 ** bits, 130
    lut = _lut(N, bits, per_col, seed=70 + bits)
    c = torch.arange(k)[:, None].expand(k, N)
    wp = tpack.pack_int4(c) if bits == 4 else (c - 128).to(torch.int8)
    # row c of eye(k) @ W is W's row c: the plain version's weight, exactly
    got = tqmm.qmatmul_lut_plain(torch.eye(k, dtype=torch.bfloat16), wp,
                                 torch.from_numpy(lut), bits=bits)
    assert torch.equal(got.to(torch.bfloat16).view(torch.int16),
                       _lut_table(lut, N).view(torch.int16))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_col", [True, False])
def test_lut_kernel_sum_order_matches_plain_and_reference(bits, per_col):
    """The transposed product from the kernel's table, summed in the
    kernel's order, agrees with ``qmatmul_lut_plain`` within the card
    check's ``TOL_QMM_LUT`` and, for the engine's (k,) codebook, with the
    reference's bf16 serving matmul within one bf16 step."""
    M, K, N = 24, 512, 192
    r = np.random.default_rng(80 + bits + per_col)
    a = (r.standard_normal((M, K)) * 0.5).astype(np.float32)
    wp, lut = _codes(K, N, bits, seed=81), _lut(N, bits, per_col, seed=82)
    twp = torch.from_numpy(wp)
    codes = (tpack.unpack_int4(twp) if bits == 4 else twp).long() \
        + tref.code_offset(2 ** bits)
    w = _lut_table(lut, N)[codes, torch.arange(N)]            # (K, N) bf16
    splitk = tqmm.default_splitk(K, N)
    kchunk = -(-K // splitk)
    kchunk = -(-kchunk // 64) * 64          # as the C entry point rounds it
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    af, wf = a16.float(), w.float()
    got = None
    for s in range(splitk):                 # the kernel's order of the sum
        acc = torch.zeros((M, N))
        for k0 in range(s * kchunk, min(K, (s + 1) * kchunk), 16):
            acc = acc + af[:, k0:k0 + 16] @ wf[k0:k0 + 16]
        got = acc if got is None else got + acc
    plain = tqmm.qmatmul_lut_plain(a16, twp, torch.from_numpy(lut),
                                   bits=bits)
    assert (got - plain).abs().max().item() <= TOL_QMM_LUT
    if not per_col:
        # the reference's bf16 serving matmul (materialize(w, x.dtype)):
        # the same bf16 products, f32 sums rounded to bf16, one step apart
        want = np.asarray(jlm.mm(jnp.asarray(a).astype(jnp.bfloat16),
                                 {"q_codes": jnp.asarray(wp),
                                  "q_lut": jnp.asarray(lut)})
                          .astype(jnp.float32))
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                                   want, atol=2 ** -8, rtol=2 ** -7)
