"""PyTorch port vs JAX reference: the dequant-fused matmul.

The port's plain version (what its wrapper computes for CPU tensors, and
what the CUDA kernel is held against on the card) is compared with the
reference's Pallas kernel in interpret mode and with its jnp oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import qmatmul as jqmm
from repro.kernels import ref as jref

from repro_torch.core import packing as tpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _inputs(M, K, N, bits, seed=0):
    """a, packed codes and per-channel stats, coded by the reference so
    both sides multiply identical codes."""
    r = np.random.default_rng(seed)
    a = (r.standard_normal((M, K)) * 0.1).astype(np.float32)
    w = (r.standard_normal((K, N)) * 0.03).astype(np.float32)
    mu = w.mean(axis=0, keepdims=True)
    sd = w.std(axis=0, keepdims=True)
    wp = np.asarray(jops.quantize_weights(
        jnp.asarray(w)[None], jnp.asarray(mu)[None], jnp.asarray(sd)[None],
        bits=bits, use_pallas=False)[0])
    return a, wp, mu, sd


def _t(*arrs):
    return [torch.from_numpy(np.array(x)) for x in arrs]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn", [(8, 64, 32), (48, 384, 192), (33, 520, 96),
                                 (5, 200, 130), (1, 16, 2)])
def test_plain_matches_reference_oracle(bits, mkn):
    M, K, N = mkn
    a, wp, mu, sd = _inputs(M, K, N, bits)
    want = np.asarray(jref.qmatmul_ref(jnp.asarray(a), jnp.asarray(wp),
                                       jnp.asarray(mu), jnp.asarray(sd),
                                       bits))
    ta, twp, tmu, tsd = _t(a, wp, mu, sd)
    got = tqmm.qmatmul(ta, twp, tmu, tsd, bits=bits)        # CPU -> plain
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    # identical codes; level tables within 5e-7; f32 sums in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    got_p = tqmm.qmatmul_plain(ta, twp, tmu, tsd, bits=bits)
    assert torch.equal(got, got_p)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mkn,blocks", [
    ((48, 384, 192), (32, 512, 512)),      # the reference's decode tiling
    ((33, 520, 96), (16, 64, 32)),         # ragged final tile on every axis
    ((16, 256, 128), (None, None, None)),  # the reference's default tiling
])
def test_plain_matches_reference_kernel_interpreted(bits, mkn, blocks):
    M, K, N = mkn
    bm, bk, bn = blocks
    a, wp, mu, sd = _inputs(M, K, N, bits, seed=1)
    out_k = np.asarray(jqmm.qmatmul(jnp.asarray(a), jnp.asarray(wp),
                                    jnp.asarray(mu), jnp.asarray(sd),
                                    bits=bits, bm=bm, bk=bk, bn=bn,
                                    interpret=True))
    got = tqmm.qmatmul(*_t(a, wp, mu, sd), bits=bits).numpy()
    # f32 activations: the reference kernel keeps its dequantized tile in
    # f32 too; the per-element erfinv of the kernel vs the level table, and
    # the tile-wise summation, stay within 1e-4 of O(0.1) results
    np.testing.assert_allclose(got, out_k, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
def test_bf16_activations_and_output(bits):
    M, K, N = 16, 128, 64
    a, wp, mu, sd = _inputs(M, K, N, bits, seed=2)
    ta, twp, tmu, tsd = _t(a, wp, mu, sd)
    a16 = ta.to(torch.bfloat16)
    got = tqmm.qmatmul(a16, twp, tmu, tsd, bits=bits,
                       out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # what the reference's serving matmul computes for bf16 activations:
    # the weight dequantized to bf16 (lm.mm -> materialize(w, x.dtype))
    from repro.models.lm import mm as jmm
    want = np.asarray(jmm(
        jnp.asarray(a).astype(jnp.bfloat16),
        {"q_codes": jnp.asarray(wp), "q_mu": jnp.asarray(mu),
         "q_sigma": jnp.asarray(sd)}).astype(jnp.float32))
    # both round f32 sums of the same bf16 products to bf16: one ulp apart
    # at most
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8,
                               rtol=2 ** -7)


@pytest.mark.parametrize("bits", [4, 8])
def test_ops_wrapper_shapes_and_per_tensor_stats(bits):
    """Leading batch dims are flattened and (1, 1) statistics broadcast."""
    B, S, K, N = 2, 3, 64, 32
    a, wp, mu, sd = _inputs(B * S, K, N, bits, seed=3)
    mu1, sd1 = mu.mean(keepdims=True), sd.mean(keepdims=True)
    ta, twp = _t(a, wp)
    tmu, tsd = _t(mu1.reshape(1, 1), sd1.reshape(1, 1))
    got = tops.qmatmul(ta.reshape(B, S, K), twp, tmu, tsd, bits=bits)
    assert tuple(got.shape) == (B, S, N)
    want = np.asarray(jref.qmatmul_ref(
        jnp.asarray(a), jnp.asarray(wp),
        jnp.broadcast_to(jnp.asarray(mu1), (1, N)),
        jnp.broadcast_to(jnp.asarray(sd1), (1, N)), bits))
    np.testing.assert_allclose(got.reshape(B * S, N).numpy(), want,
                               atol=2e-5, rtol=1e-5)
    plain = tops.qmatmul(ta.reshape(B, S, K), twp, tmu, tsd, bits=bits,
                         use_kernel=False)
    assert torch.equal(got, plain)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, wp, mu, sd = _inputs(4, 16, 8, 4)
    ta, twp, tmu, tsd = _t(a, wp, mu, sd)
    with pytest.raises(ValueError):
        tqmm.qmatmul(ta, twp, tmu, tsd, bits=3)
    with pytest.raises(TypeError):
        tqmm.qmatmul(ta, twp.to(torch.int8), tmu, tsd, bits=4)
    with pytest.raises(ValueError):
        tqmm.qmatmul(ta[:, :8], twp, tmu, tsd, bits=4)           # K mismatch
    with pytest.raises(ValueError):
        tqmm.qmatmul(ta, twp, tmu[:, :4], tsd, bits=4)           # stats shape
    with pytest.raises(TypeError):
        tqmm.qmatmul(ta.to(torch.float64), twp, tmu, tsd, bits=4)
    with pytest.raises(TypeError):
        tqmm.qmatmul(ta, twp, tmu, tsd, bits=4, out_dtype=torch.float16)


def test_block_config_axis():
    """Block shapes stay a config axis; the split count over K depends on
    (K, N) only, so a row's bits cannot depend on M.  Prefill takes a tall
    tile of the warpgroup body (a weight stage is decoded once per block);
    ``qmatmul_a8``'s widest tile stays 64 rows."""
    assert tqmm.default_blocks(1).bm == 8
    assert tqmm.default_blocks(16).bm == 16
    assert tqmm.default_blocks(32) == tqmm.TUNED_BLOCKS["decode"]
    assert tqmm.default_blocks(33) == tqmm.TUNED_BLOCKS["prefill64"]
    assert tqmm.default_blocks(65) == tqmm.TUNED_BLOCKS["prefill"]
    assert tqmm.default_blocks(4096).bm == 128
    assert tqmm.default_blocks(32, a8=True) == tqmm.TUNED_BLOCKS["decode"]
    assert tqmm.default_blocks(4096, a8=True).bm == 64
    for M in (1, 16, 32, 33, 256, 4096):
        assert tqmm.default_blocks(M).bm in tqmm._TILES["qmatmul_launch"]
        assert tqmm.default_blocks(M, a8=True).bm in \
            tqmm._TILES["qmatmul_a8_launch"]
    for K, N in [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096),
                 (64, 32), (200, 130)]:
        s = tqmm.default_splitk(K, N)
        assert 1 <= s <= 16 and s * 256 <= max(K, 256)
        assert s & (s - 1) == 0                     # a power of two
    assert tqmm.default_splitk(4096, 4096) > 1      # decode fills the card
    with pytest.raises(Exception):
        tqmm.BlockConfig(bm=8).bm = 16              # frozen


def test_launch_counter_counts_only_kernel_launches():
    """On CPU tensors the wrapper takes the plain version: no launch."""
    before = tops.launch_counts()
    a, wp, mu, sd = _inputs(4, 16, 8, 4)
    tqmm.qmatmul(*_t(a, wp, mu, sd), bits=4)
    assert tops.launch_counts() == before
    assert set(before) == {"qmatmul", "paged_quant_attention",
                           "uniq_noise_fwd", "uniq_noise_bwd", "qmatmul_a8",
                           "qmatmul_lut", "kquantile_quantize",
                           "kquantile_dequantize", "uniq_noise_fwd_onchip",
                           "kquantile_dequantize_paged", "kv_append",
                           "qmatmul_experts", "qmatmul_lut_experts"}


# -- the warpgroup body's arithmetic, emulated on the CPU ---------------------
#
# For bf16 activations the CUDA kernel multiplies by a per-block table of
# bf16 levels, bf16(mu + sigma * T[c]) with a separate f32 multiply and add,
# and sums over K in 16-row steps inside each split, then over the splits
# left to right (csrc/qmatmul.cu, qmatmul_wg_kernel).  The tests below hold
# that emulation to the plain version and to the reference.

# chip_smoke.py's TOL_QMM_F32: the card check holds the kernel to the plain
# version within this; the emulation is held to the same bound here.
TOL_QMM_F32 = 5e-4


def _gauss_table(bits, mu, sd):
    """The kernel's table for every code x column: f32 multiply, then f32
    add, then round to nearest even bf16 (numpy's float32 ops round each
    result once, like __fmul_rn / __fadd_rn)."""
    k = 2 ** bits
    t = tref.level_table(k).numpy()[:, None]
    lv = np.float32(mu) + np.float32(sd) * t                  # (k, N) f32
    return torch.from_numpy(lv.astype(np.float32)).to(torch.bfloat16)


def _all_codes(bits, N):
    """A (k, N) weight whose row c holds code c in every column, stored as
    the kernel reads it (packed at W4, offset by -128 at W8)."""
    k = 2 ** bits
    c = torch.arange(k)[:, None].expand(k, N)
    return tpack.pack_int4(c) if bits == 4 else (c - 128).to(torch.int8)


def _stats_for(kind, N, seed):
    r = np.random.default_rng(seed)
    mu = (r.standard_normal((1, N)) * 0.01).astype(np.float32)
    sd = (0.02 * (0.5 + r.random((1, N)))).astype(np.float32)
    if kind == "per_tensor":
        # one value each, broadcast to (1, N) the way ops._stats does
        return (tops._stats(torch.from_numpy(mu[:, :1]), N).numpy(),
                tops._stats(torch.from_numpy(sd[:, :1]), N).numpy())
    return mu, sd


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kind", ["per_channel", "per_tensor"])
def test_kernel_level_table_is_the_plain_bf16_weight(bits, kind):
    """Every code x column of the kernel's table equals, bit for bit, the
    weight the plain version multiplies for bf16 activations."""
    k, N = 2 ** bits, 130
    mu, sd = _stats_for(kind, N, seed=50 + bits)
    table = _gauss_table(bits, mu, sd)
    wp = _all_codes(bits, N)
    # the plain version's weight, read through the plain product with an
    # identity: row c of eye(k) @ W is W's row c, exactly
    eye = torch.eye(k, dtype=torch.bfloat16)
    got = tqmm.qmatmul_plain(eye, wp, torch.from_numpy(mu),
                             torch.from_numpy(sd), bits=bits)
    assert torch.equal(got.to(torch.bfloat16).view(torch.int16),
                       table.view(torch.int16))
    # and the plain version's own dequantization, to the bit
    codes = tpack.unpack_int4(wp) if bits == 4 else wp
    w = tref.kquantile_dequant_ref(codes, torch.from_numpy(mu),
                                   torch.from_numpy(sd), k,
                                   dtype=torch.bfloat16)
    assert torch.equal(w.view(torch.int16), table.view(torch.int16))


def _kernel_sum(a, w, splitk):
    """The kernel's order of the f32 sum: within each split of K (its
    length rounded up to 64 rows, as the C entry point does) 16-row steps
    from zero, then the splits added left to right."""
    M, K = a.shape
    kchunk = -(-K // splitk)
    kchunk = -(-kchunk // 64) * 64
    a, w = a.to(torch.float32), w.to(torch.float32)
    out = None
    for s in range(splitk):
        acc = torch.zeros((M, w.shape[1]), dtype=torch.float32)
        for k0 in range(s * kchunk, min(K, (s + 1) * kchunk), 16):
            acc = acc + a[:, k0:k0 + 16] @ w[k0:k0 + 16]
        out = acc if out is None else out + acc
    return out


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kind", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("M", [16, 40])
def test_kernel_sum_order_matches_plain_and_reference(bits, kind, M):
    """The transposed product from the kernel's table, summed in the
    kernel's order, agrees with ``qmatmul_plain`` within the card check's
    ``TOL_QMM_F32`` and, rounded to bf16, with the reference's bf16 serving
    matmul within one bf16 step."""
    K, N = 512, 192
    r = np.random.default_rng(60 + M + bits)
    a = (r.standard_normal((M, K))).astype(np.float32)
    codes = r.integers(0, 2 ** bits, size=(K, N))
    mu, sd = _stats_for(kind, N, seed=61 + bits)
    wp = tpack.pack_int4(torch.from_numpy(codes)) if bits == 4 else \
        torch.from_numpy(codes - 128).to(torch.int8)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    table = _gauss_table(bits, mu, sd)
    w = table[torch.from_numpy(codes), torch.arange(N)]       # (K, N) bf16
    splitk = tqmm.default_splitk(K, N)
    assert splitk > 1                      # the fold over splits is exercised
    got = _kernel_sum(a16, w, splitk)
    tmu, tsd = torch.from_numpy(mu), torch.from_numpy(sd)
    plain = tqmm.qmatmul_plain(a16, wp, tmu, tsd, bits=bits)
    assert (got - plain).abs().max().item() <= TOL_QMM_F32
    from repro.models.lm import mm as jmm
    want = np.asarray(jmm(jnp.asarray(a).astype(jnp.bfloat16),
                          {"q_codes": jnp.asarray(wp.numpy()),
                           "q_mu": jnp.asarray(mu),
                           "q_sigma": jnp.asarray(sd)}).astype(jnp.float32))
    # both round f32 sums of the same bf16 products to bf16: one step apart
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                               atol=2 ** -8, rtol=2 ** -7)
