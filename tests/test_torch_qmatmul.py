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

from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmatmul as tqmm


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
    (K, N) only, so a row's bits cannot depend on M."""
    assert tqmm.default_blocks(1).bm == 8
    assert tqmm.default_blocks(16).bm == 16
    assert tqmm.default_blocks(32) == tqmm.TUNED_BLOCKS["decode"]
    assert tqmm.default_blocks(33) == tqmm.TUNED_BLOCKS["prefill"]
    assert tqmm.default_blocks(4096).bm == 64
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
                           "kquantile_dequantize", "uniq_noise_fwd_onchip"}
