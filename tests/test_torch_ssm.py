"""PyTorch port vs JAX reference: the Mamba-2 SSD block (``models/ssm.py``).

The same numpy inputs, made from a seed, go through ``repro.models.ssm``
(JAX, CPU) and ``repro_torch.models.ssm`` (CPU): the depthwise causal
convolution, the chunked SSD scan (the chunk dividing S, the one-chunk
fallback, and decays steep enough to overflow the masked upper triangle),
the one-token decode step, the whole block with its decode cache (dense and
with coded projections, which the port multiplies through ``lm.mm`` where
the reference materializes them), the block's decode step, and the port's
decode stepping against its own block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import hybrid as jhy
from repro.models import lm as jlm
from repro.models import model as jmodel
from repro.models import ssm as jssm

from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.models import hybrid as thy
from repro_torch.models import ssm as tssm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# f32 on both sides; only the order of the sums differs (XLA's convolution
# and einsums against torch's): a few f32 ulps of O(1) values
TOL_F32 = 1e-5
# the scan's outputs grow with the state (O(10) here): stated relative to
# the largest output
TOL_SCAN_REL = 1e-5
# bf16 results: the f32 values are rounded to bf16 on both sides, so a
# value next to a rounding boundary may land one bf16 step (2^-8 relative)
# away
TOL_BF16_REL = 2.0 ** -8


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _scan_inputs(seed, B=2, S=32, nh=4, hd=8, n=16, dt_scale=1.0):
    r = _rng(seed)
    x = r.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = (np.log1p(np.exp(r.standard_normal((B, S, nh)))) * 0.1
          * dt_scale).astype(np.float32)
    A_log = np.log(np.arange(1, nh + 1, dtype=np.float32))
    Bm = r.standard_normal((B, S, n)).astype(np.float32)
    Cm = r.standard_normal((B, S, n)).astype(np.float32)
    D = (1.0 + 0.1 * r.standard_normal(nh)).astype(np.float32)
    return x, dt, A_log, Bm, Cm, D


def _close(got, want, tol_rel, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max()
    assert err <= tol_rel * max(1.0, np.abs(want).max()), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype):
    r = _rng(0)
    xbc = r.standard_normal((2, 13, 24)).astype(np.float32)
    w = (r.standard_normal((24, 4)) * 0.5).astype(np.float32)
    b = (r.standard_normal(24) * 0.1).astype(np.float32)
    jx = jnp.asarray(xbc).astype(dtype)
    want = jssm.causal_conv1d(jx, jnp.asarray(w), jnp.asarray(b))
    got = tssm.causal_conv1d(_t(xbc).to(getattr(torch, dtype)), _t(w), _t(b))
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, _np(want), TOL_F32 if dtype == "float32" else TOL_BF16_REL)
    # causal: a change at position t moves no output before t
    bumped = xbc.copy()
    bumped[:, 7] += 1.0
    again = tssm.causal_conv1d(_t(bumped), _t(w), _t(b))
    base = tssm.causal_conv1d(_t(xbc), _t(w), _t(b))
    assert torch.equal(again[:, :7], base[:, :7])
    assert not torch.equal(again[:, 7], base[:, 7])


@pytest.mark.parametrize("S,chunk", [(32, 8), (32, 32), (20, 8), (7, 128)])
def test_ssd_scan_matches_reference(S, chunk):
    """The chunk dividing S (several chunks carry the state), and not
    dividing it (the whole sequence as one chunk, the reference's rule)."""
    ins = _scan_inputs(S, S=S)
    y_j, h_j = jssm.ssd_scan(*map(jnp.asarray, ins), chunk=chunk)
    y_t, h_t = tssm.ssd_scan(*map(_t, ins), chunk=chunk)
    _close(y_t, y_j, TOL_SCAN_REL, "y")
    _close(h_t, h_j, TOL_SCAN_REL, "h")
    assert h_t.dtype == torch.float32


def test_ssd_scan_masks_overflowing_decays_by_selection():
    """Steep decays make exp(cs_i - cs_j) overflow to inf above the
    diagonal: the masked scores must be dropped (``where``), not multiplied
    by 0 (inf * 0 = NaN)."""
    ins = _scan_inputs(5, S=32, dt_scale=400.0)
    x, dt, A_log = ins[:3]
    cs = np.cumsum(dt * -np.exp(A_log), axis=1)
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.exp(cs[:, None] - cs[:, :, None])).all()
    y_j, h_j = jssm.ssd_scan(*map(jnp.asarray, ins), chunk=32)
    y_t, h_t = tssm.ssd_scan(*map(_t, ins), chunk=32)
    assert torch.isfinite(y_t).all() and torch.isfinite(h_t).all()
    _close(y_t, y_j, TOL_SCAN_REL, "y")
    _close(h_t, h_j, TOL_SCAN_REL, "h")


def test_ssd_scan_bf16_inputs_match_reference():
    ins = list(_scan_inputs(3, S=16))
    xb = jnp.asarray(ins[0]).astype(jnp.bfloat16)
    y_j, h_j = jssm.ssd_scan(xb, *map(jnp.asarray, ins[1:]), chunk=8)
    x_t = _t(ins[0]).to(torch.bfloat16)
    y_t, h_t = tssm.ssd_scan(x_t, *map(_t, ins[1:]), chunk=8)
    assert y_t.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    _close(y_t, _np(y_j), 2 * TOL_BF16_REL, "y")
    _close(h_t, h_j, TOL_SCAN_REL, "h")


def test_ssd_decode_step_matches_reference():
    x, dt, A_log, Bm, Cm, D = _scan_inputs(7, S=1)
    h = _rng(8).standard_normal((2, 4, 8, 16)).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A_log, Bm[:, 0], Cm[:, 0], D, h)
    y_j, h_j = jssm.ssd_decode_step(*map(jnp.asarray, args))
    y_t, h_t = tssm.ssd_decode_step(*map(_t, args))
    _close(y_t, y_j, TOL_F32, "y")
    _close(h_t, h_j, TOL_F32, "h")


def test_ssm_dims_match_reference_at_full_width():
    for arch, want in (("mamba2_1_3b", 8512), ("zamba2_2_7b", 10448)):
        dj = jhy.ssm_dims(jcb.get(arch))
        dt = thy.ssm_dims(tcb.get(arch))
        assert tuple(dt) == tuple(dj)
        assert dt.in_proj_out == dj.in_proj_out == want
        assert dt.conv_channels == dj.conv_channels


@functools.lru_cache(maxsize=None)
def _dense_tree():
    return jmodel.init(jax.random.PRNGKey(0), jcb.get_smoke("mamba2_1_3b"))


@functools.lru_cache(maxsize=None)
def _layer0(bits):
    """Layer 0 of the reference's mamba2 smoke tree (coded at W4 / W8),
    as numpy and as the port's tensors, and the block's dims."""
    cfg = jcb.get_smoke("mamba2_1_3b")
    pj = _dense_tree()
    if bits < 16:
        pj = jmodel.quantize_for_serving(pj, bits)
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], pj["layers"])
    return lp, convert.params_from_numpy(lp, device="cpu"), \
        jhy.ssm_dims(cfg)


def _dense_ref(lp):
    """The reference's per-layer view: projections materialized (f32)."""
    return {k: (jlm.materialize(v, jnp.float32)
                if k in ("in_proj", "out_proj") else jnp.asarray(v))
            for k, v in lp.items()}


@pytest.mark.parametrize("bits", [16, 4, 8])
@pytest.mark.parametrize("S", [16, 12])
def test_mamba2_block_and_state_match_reference(bits, S):
    """Output and decode cache (pre-conv window, final state); coded
    projections go through ``lm.mm`` in the port and through
    ``materialize`` + ``jnp.dot`` in the reference: the same function."""
    lp_np, lp_t, dims = _layer0(bits)
    x = (_rng(S).standard_normal((2, S, dims.d_model)) * 0.5).astype(
        np.float32)
    out_j, conv_j, h_j = jssm.mamba2_block(jnp.asarray(x), _dense_ref(lp_np),
                                           dims, chunk=8, state_out=True)
    out_t, conv_t, h_t = tssm.mamba2_block(_t(x), lp_t, dims, chunk=8,
                                           state_out=True)
    _close(out_t, out_j, TOL_F32, "out")
    _close(conv_t, conv_j, TOL_F32, "conv window")
    _close(h_t, h_j, TOL_F32, "state")
    assert tuple(conv_t.shape) == (2, dims.d_conv - 1, dims.conv_channels)
    assert torch.equal(tssm.mamba2_block(_t(x), lp_t, dims, chunk=8),
                       out_t)


@pytest.mark.parametrize("bits", [16, 4])
def test_mamba2_decode_matches_reference(bits):
    lp_np, lp_t, dims = _layer0(bits)
    r = _rng(11)
    x = (r.standard_normal((3, 1, dims.d_model)) * 0.5).astype(np.float32)
    conv = r.standard_normal((3, dims.d_conv - 1, dims.conv_channels)
                             ).astype(np.float32)
    h = r.standard_normal((3, dims.n_heads, dims.headdim, dims.state)
                          ).astype(np.float32)
    y_j, conv_j, h_j = jssm.mamba2_decode(jnp.asarray(x), _dense_ref(lp_np),
                                          dims, jnp.asarray(conv),
                                          jnp.asarray(h))
    conv_in, h_in = _t(conv), _t(h)
    y_t, conv_t, h_t = tssm.mamba2_decode(_t(x), lp_t, dims, conv_in, h_in)
    _close(y_t, y_j, TOL_F32, "y")
    _close(conv_t, conv_j, TOL_F32, "conv window")
    _close(h_t, h_j, TOL_F32, "state")
    # the caches passed in are not written
    assert torch.equal(conv_in, _t(conv)) and torch.equal(h_in, _t(h))


def test_decode_stepping_matches_the_block():
    """Stepping S tokens through ``mamba2_decode`` from zero caches gives
    the block's outputs, its pre-conv window and its final state."""
    _, lp_t, dims = _layer0(4)
    S = 10
    x = torch.from_numpy((_rng(2).standard_normal((2, S, dims.d_model))
                          * 0.5).astype(np.float32))
    out, conv_b, h_b = tssm.mamba2_block(x, lp_t, dims, chunk=4,
                                         state_out=True)
    conv = torch.zeros((2, dims.d_conv - 1, dims.conv_channels))
    h = torch.zeros((2, dims.n_heads, dims.headdim, dims.state))
    ys = []
    for t in range(S):
        y, conv, h = tssm.mamba2_decode(x[:, t:t + 1], lp_t, dims, conv, h)
        ys.append(y)
    _close(torch.cat(ys, 1), out.numpy(), TOL_F32, "outputs")
    _close(conv, conv_b.numpy(), TOL_F32, "conv window")
    _close(h, h_b.numpy(), TOL_F32, "state")
