"""PyTorch port: the on-chip UNIQ noise of ``uniq_noise_fwd_onchip``.

The CUDA kernel draws e01 inside from Philox4x32-10 keyed by the leaf key;
its plain version (``ref.philox4x32_10`` / ``ref.onchip_e01``) gives the same
bits as int64 torch ops, and the card holds the kernel to it bit for bit
(``chip_smoke.py`` phase 3).  Here, on the CPU: the generator against
Random123's known-answer vectors and an independent Python-int Philox; the
draw's layout (lane i % 4 of counter i / 4) and its independence of the
(G, R, C) grouping; the on-chip body at zero bits against the reference's
``uniq_noise_fwd_onchip`` in interpret mode (whose interpreter stubs the TPU
PRNG to zeros); and ``uniq_transform_onchip`` against ``uniq_transform``
given the same bits, forward and gradient.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import uniq_noise as jun

from repro_torch.core import distributions as tdist
from repro_torch.core import uniq as tuniq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import uniq_noise as tun


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLEAN, NOISE, FROZEN = 0, 1, 2
U32 = 0xFFFFFFFF

# Random123's known-answer vectors of Philox4x32-10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((U32, U32, U32, U32), (U32, U32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]

# The same tolerances as test_torch_uniq_noise: FROZEN levels of two
# erfinv implementations (relative to sigma); a FROZEN code may flip only
# this close to a bin edge; NOISE: four ulps of u either side, magnified by
# 1 / pdf(z_hat).
TOL_LEVEL_SIGMA = 1e-5
EDGE = 1e-4
TOL_NOISE_U = 4 * 2.0 ** -24


def _philox_int(ctr, key):
    """Philox4x32-10 on Python ints (arbitrary precision: no overflow to
    reason about), independent of the port's int64 formulation."""
    c = list(ctr)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & U32, (k1 + 0xBB67AE85) & U32
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & U32, p1 & U32,
             ((p0 >> 32) ^ c[3] ^ k1) & U32, p0 & U32]
    return tuple(c)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answer_vectors(case):
    ctr, key, want = KAT[case]
    got = tref.philox4x32_10(ctr, key)
    assert tuple(int(x) for x in got) == want
    assert _philox_int(ctr, key) == want


def test_philox_matches_the_python_int_version_on_random_words():
    """Random counters with every word in use, and keys near 2^32: the
    int64 products split into 16-bit halves never overflow."""
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 1 << 32, size=(4, 64), dtype=np.uint64)
    ctr[:, :4] = U32                          # the largest operands
    for key in ((U32, U32), (0, 1), (0x12345678, 0xFEDCBA98)):
        got = tref.philox4x32_10([torch.from_numpy(c.astype(np.int64))
                                  for c in ctr], key)
        got = np.stack([g.numpy() for g in got])
        for j in range(ctr.shape[1]):
            want = _philox_int(tuple(int(x) for x in ctr[:, j]), key)
            assert tuple(int(x) for x in got[:, j]) == want


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1031])
def test_onchip_e01_layout(n):
    """Element i is lane i % 4 of the counter (i / 4 as two u32 words, 0,
    0), under the key's (low, high) words, mapped by (x >> 8) * 2^-24:
    exact f32 values in [0, 1)."""
    key = 0x7FEDCBA987654321
    e = tref.onchip_e01(key, n)
    assert e.dtype == torch.float32 and tuple(e.shape) == (n,)
    words = (key & U32, key >> 32)
    for i in range(n):
        x = _philox_int((i // 4, 0, 0, 0), words)[i % 4]
        assert float(e[i]) == (x >> 8) * 2.0 ** -24
    assert float(e.min()) >= 0.0 and float(e.max()) < 1.0


def test_onchip_e01_high_counter_word():
    """Runs past 2^32 put the run index's high half in counter word 1: the
    formula, checked on the counters themselves (a draw that long is not
    made here)."""
    runs = torch.tensor([(1 << 32) + 5, (3 << 32) + U32], dtype=torch.int64)
    zero = torch.zeros_like(runs)
    key = (0xDEADBEEF, 0x01234567)
    got = tref.philox4x32_10((runs & U32, runs >> 32, zero, zero), key)
    for j, r in enumerate(runs.tolist()):
        want = _philox_int((r & U32, r >> 32, 0, 0), key)
        assert tuple(int(g[j]) for g in got) == want


def test_onchip_e01_moments_and_keys():
    n = 1 << 18
    e = tref.onchip_e01(12345, n).double()
    # six standard errors of the mean and of the variance of U[0, 1)
    assert abs(e.mean().item() - 0.5) < 6 * math.sqrt(1 / 12 / n)
    assert abs(e.var(correction=0).item() - 1 / 12) < \
        6 * math.sqrt(1 / 80 - 1 / 144) / math.sqrt(n)
    other = tref.onchip_e01(12346, n).double()
    assert (other == e).double().mean().item() < 1e-3
    assert torch.equal(tref.onchip_e01(12345, n).double(), e)


def _leaf(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.03 + 0.004)
                            .astype(np.float32))


@pytest.mark.parametrize("grouping", [(1, 72, 10), (3, 24, 10), (9, 8, 10),
                                      (720, 1, 1)])
def test_draw_is_independent_of_the_grouping(grouping):
    """The same leaf (720 elements) in other (G, R, C) views, per-tensor
    statistics (as ``transform_param`` fits them) and every group NOISE:
    the flat output is the same, because the draw depends on (key, flat
    index) only."""
    w = _leaf((720,), seed=1)
    fit = tdist.GaussianModel.fit(w)
    mu, sd = fit.mu.reshape(()), fit.sigma.reshape(())
    key = 0x1234ABCD5678
    flat = (1, 720, 1)

    def run(shape):
        G = shape[0]
        return tun.uniq_noise_fwd_onchip(
            w.view(shape), mu.expand(G, 1, 1).contiguous(),
            sd.expand(G, 1, 1).contiguous(),
            torch.full((G,), NOISE, dtype=torch.int32), key, k=16)
    assert torch.equal(run(grouping).reshape(-1), run(flat).reshape(-1))
    # and transform_param on a conv-shaped leaf equals the flat transform
    conv = w.view(3, 3, 8, 10)
    cfg = tuniq.UniqConfig(w_bits=4)
    out = tuniq.transform_param(conv, key, NOISE, cfg)
    assert torch.equal(out.reshape(-1), run(flat).reshape(-1))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    G = shape[0]
    scale = rng.uniform(0.01, 0.05, size=(G, 1, 1)).astype(np.float32)
    w = (rng.standard_normal(shape).astype(np.float32) * scale
         + 0.1 * scale).astype(np.float32)
    mu = w.mean(axis=(1, 2), keepdims=True, dtype=np.float64)
    sd = w.std(axis=(1, 2), keepdims=True, dtype=np.float64)
    return w, mu.astype(np.float32), np.maximum(sd, 1e-8).astype(np.float32)


def _u64(w, mu, sd):
    z = (w.astype(np.float64) - mu) / sd
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


@pytest.mark.parametrize("k", [4, 16, 256])
def test_onchip_body_at_zero_bits_matches_reference_interpreter(k):
    """The Pallas interpreter stubs the TPU PRNG to zeros, so the
    reference's on-chip kernel, interpreted, is its body at e01 = 0: it
    equals its own host-noise kernel on zeros bit for bit.  The port's body
    (shared by both of its forwards) on the same zeros is held to it with
    the tolerances of test_torch_uniq_noise."""
    shape = (3, 16, 128)
    w, mu, sd = _inputs(shape, seed=k)
    modes = [CLEAN, NOISE, FROZEN]
    args = (jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sd),
            jnp.asarray(modes, jnp.int32))
    out_j = np.asarray(jun.uniq_noise_fwd_onchip(*args, jnp.int32(7), k=k,
                                                 interpret=True))
    zeros = np.zeros(shape, np.float32)
    host_j = np.asarray(jun.uniq_noise_fwd(*args, jnp.asarray(zeros), k=k,
                                           interpret=True))
    np.testing.assert_array_equal(out_j, host_j)
    out_t = tun.uniq_noise_fwd(torch.from_numpy(w), torch.from_numpy(mu),
                               torch.from_numpy(sd),
                               torch.tensor(modes, dtype=torch.int32),
                               torch.from_numpy(zeros), k=k).numpy()
    sig = np.broadcast_to(sd, shape)
    excess = np.abs(out_t - out_j) / sig
    np.testing.assert_array_equal(out_t[0], w[0])                # CLEAN
    zh = (out_j[1] - mu[1]) / sd[1]                              # NOISE
    pdf = np.exp(-0.5 * np.square(zh)) / math.sqrt(2.0 * math.pi)
    assert (excess[1] <= TOL_NOISE_U / pdf + TOL_LEVEL_SIGMA).all()
    uk = _u64(w[2], mu[2], sd[2]) * k                            # FROZEN
    off = excess[2] > TOL_LEVEL_SIGMA
    assert np.all(np.abs(uk - np.round(uk))[off] < EDGE)
    assert off.sum() <= 2


def test_onchip_plain_is_the_transform_on_the_plain_draw():
    """The wrapper's CPU path is ``uniq_noise_fwd_onchip_plain``:
    ``ref.uniq_transform_ref`` on ``ref.onchip_e01(key)``, bit for bit, and
    the host-noise forward on those bits gives the same values."""
    w, mu, sd = (torch.from_numpy(x) for x in _inputs((3, 5, 7), seed=3))
    mode = torch.tensor([CLEAN, NOISE, FROZEN], dtype=torch.int32)
    key = (1 << 63) + 12345                   # the high word's top bit set
    e01 = tref.onchip_e01(key, w.numel()).view(w.shape)
    before = tops.launch_counts()
    out = tun.uniq_noise_fwd_onchip(w, mu, sd, mode, key, k=16)
    assert tops.launch_counts() == before             # CPU: no launch
    assert torch.equal(out, tref.uniq_transform_ref(w, mu, sd, e01, mode,
                                                    16))
    assert torch.equal(out, tun.uniq_noise_fwd(w, mu, sd, mode, e01, k=16))
    assert torch.equal(tun.onchip_e01(key, w.numel(), "cpu"),
                       e01.reshape(-1))
    with pytest.raises(ValueError):
        tun.uniq_noise_fwd_onchip(w, mu, sd, mode, -1, k=16)
    with pytest.raises(ValueError):
        tun.uniq_noise_fwd_onchip(w, mu, sd, mode, 1 << 64, k=16)
    with pytest.raises(ValueError):
        tun.uniq_noise_fwd_onchip(w, mu, sd, mode, key, k=12)
    with pytest.raises(ValueError):
        tun.uniq_noise_fwd_onchip(w, mu, sd, mode[:2], key, k=16)


@pytest.mark.parametrize("k", [4, 16])
def test_transform_onchip_equals_transform_on_the_same_bits(k):
    """``uniq_transform_onchip`` and ``uniq_transform`` given
    ``e01 = onchip_e01(key)``: the same forward and the same gradient, to
    the bit (one body, one backward)."""
    w, mu, sd = (torch.from_numpy(x) for x in _inputs((3, 37, 131), 10 + k))
    mode = torch.tensor([CLEAN, NOISE, FROZEN])
    key = 0xC0FFEE
    e01 = tref.onchip_e01(key, w.numel()).view(w.shape)
    cot = torch.randn(w.shape, generator=torch.Generator().manual_seed(k))
    res = []
    for fn, noise in ((tops.uniq_transform_onchip, key),
                      (tops.uniq_transform, e01)):
        wt = w.clone().requires_grad_(True)
        out = fn(wt, mu, sd, mode, noise, k=k)
        (out * cot).sum().backward()
        res.append((out.detach(), wt.grad))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
    # and through use_kernel=False (the comparison hook) the same
    wt = w.clone().requires_grad_(True)
    out = tops.uniq_transform_onchip(wt, mu, sd, mode, key, k=k,
                                     use_kernel=False)
    (out * cot).sum().backward()
    assert torch.equal(out.detach(), res[0][0])
    assert torch.equal(wt.grad, res[0][1])


def test_onchip_noise_source_keys_each_leaf_like_leaf_noise():
    """``onchip_noise(seed, step)`` gives a leaf the key that
    ``leaf_noise`` seeds its generator with; ``transform_tree`` sends it to
    the on-chip transform."""
    src = tuniq.onchip_noise(3, 5)
    leaf = torch.empty(4, 6)
    assert src("a/b", leaf) == tuniq.leaf_key(3, 5, "a/b")
    assert src("a/b", leaf) != src("a/c", leaf)
    assert src("a/b", leaf) != tuniq.onchip_noise(3, 6)("a/b", leaf)
    gen = torch.Generator().manual_seed(src("w", leaf))
    want = torch.rand((4, 6), generator=gen)
    assert torch.equal(tuniq.leaf_noise(3, 5)("w", leaf), want)
    params = {"w": _leaf((4, 6), seed=2), "norm": torch.ones(6)}
    cfg = tuniq.UniqConfig(w_bits=4)
    out = tuniq.transform_tree(params, src, NOISE, cfg)
    assert torch.equal(out["norm"], params["norm"])
    assert torch.equal(out["w"], tuniq.transform_param(
        params["w"], src("w", leaf), NOISE, cfg))
    assert not torch.equal(out["w"], params["w"])


# -- the forward's two CUDA bodies, and one mode by value ---------------------

def _trainer_leaf_shapes():
    """(G, R, C) kernel layouts of the leaves the trainers transform:
    ResNet-18 at its published width and MobileNet (the CNN trainer), and
    granite_3_8b's stacked layer leaves, embedding and head (the LM
    trainer, 8 layers as its full-width run)."""
    from repro_torch.cnn import cnn as tcnn
    from repro_torch.configs import base as tcb
    shapes = []
    for p in (tcnn.init_resnet18(0, width=64, device="cpu"),
              tcnn.init_mobilenet(0, width=16, device="cpu")):
        shapes += [tuple(tops._grouped(p[name])[0].shape)
                   for name in tcnn.layer_names(p)
                   if tcnn.cnn_quant_filter(name, p[name])]
    c = tcb.get("granite_3_8b")
    L, d, q, kv = 8, c.d_model, c.n_heads * c.head_dim, \
        c.n_kv_heads * c.head_dim
    shapes += [(L, d, q), (L, d, kv), (L, q, d), (L, d, c.d_ff),
               (L, c.d_ff, d), (1, c.vocab, d), (1, d, c.vocab)]
    return shapes


def test_onchip_route_takes_every_trainer_leaf_to_the_group_body():
    """Per-group statistics (how both trainers fit them) and R * C a
    multiple of 4 below 2^31: every leaf of ResNet-18, MobileNet and
    granite_3_8b goes to the per-group body."""
    shapes = _trainer_leaf_shapes()
    assert len(shapes) == 21 + 16 + 7
    assert (3, 3 * 512, 512) in shapes and (3, 3, 128) in shapes
    for (G, R, C) in shapes:
        assert tun.onchip_route(G, R, C, False) == tun.GROUP, (G, R, C)


@pytest.mark.parametrize("shape,per_col,route", [
    ((3, 37, 131), False, "flat"),          # R * C not a multiple of 4
    ((2, 5, 7), False, "flat"),
    ((1, 1, 3), False, "flat"),
    ((3, 3, 128), True, "flat"),            # per-column statistics
    ((8, 4096, 12800), True, "flat"),
    ((1, 1 << 16, 1 << 15), False, "flat"),  # R * C = 2^31
    ((70000, 1, 4), False, "flat"),         # G beyond the grid's y limit
    ((65535, 1, 4), False, "group"),
    ((1, (1 << 29) - 1, 4), False, "group"),
    ((2, 1, 4), False, "group")])
def test_onchip_route_on_ragged_and_per_column_shapes(shape, per_col, route):
    assert tun.onchip_route(*shape, per_col) == route


def test_noise_draw_does_not_depend_on_the_other_groups_modes():
    """A NOISE group's output is its own weights and its own stretch of the
    leaf's draw (counters from its flat offset): the other groups' modes,
    CLEAN, FROZEN or NOISE, change nothing in it, in the on-chip and the
    host-noise forwards."""
    w, mu, sd = (torch.from_numpy(x) for x in _inputs((3, 6, 20), seed=21))
    key = 0xABCDEF0123
    e01 = tref.onchip_e01(key, w.numel()).view(w.shape)
    outs = []
    for others in ((CLEAN, CLEAN), (FROZEN, NOISE), (NOISE, FROZEN),
                   (NOISE, NOISE)):
        mode = torch.tensor([others[0], NOISE, others[1]], dtype=torch.int32)
        on = tun.uniq_noise_fwd_onchip(w, mu, sd, mode, key, k=16)
        host = tun.uniq_noise_fwd(w, mu, sd, mode, e01, k=16)
        assert torch.equal(on, host)
        outs.append(on[1])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    # and it is the flat leaf's draw at that group's offsets
    alone = tref.uniq_transform_ref(w[1:2], mu[1:2], sd[1:2], e01[1:2],
                                    torch.tensor([NOISE], dtype=torch.int32),
                                    16)
    assert torch.equal(outs[0], alone[0])


@pytest.mark.parametrize("m", [CLEAN, NOISE, FROZEN])
def test_one_mode_by_value_equals_the_mode_tensor(m):
    """One mode for every group given as an int (passed to the kernels by
    value) is the same computation as the (G,) tensor of it: both forwards,
    the backward, and ``uniq_transform_onchip`` with its gradient; a host
    scalar tensor goes by value too, a (G,) tensor stays a tensor."""
    w, mu, sd = (torch.from_numpy(x) for x in _inputs((3, 8, 12), seed=30))
    G = w.shape[0]
    mode_t = torch.full((G,), m, dtype=torch.int32)
    key = 0x5EED
    e01 = tref.onchip_e01(key, w.numel()).view(w.shape)
    a = tun.uniq_noise_fwd_onchip(w, mu, sd, m, key, k=16)
    assert torch.equal(a, tun.uniq_noise_fwd_onchip(w, mu, sd, mode_t, key,
                                                    k=16))
    assert torch.equal(tun.uniq_noise_fwd(w, mu, sd, m, e01, k=16),
                       tun.uniq_noise_fwd(w, mu, sd, mode_t, e01, k=16))
    g = torch.from_numpy(_rng_normal(w.shape, seed=31))
    assert torch.equal(tun.uniq_noise_bwd(g, w, a, mu, sd, m),
                       tun.uniq_noise_bwd(g, w, a, mu, sd, mode_t))
    assert tops._group_modes(m, w) == m
    assert tops._group_modes(torch.tensor(m), w) == m
    assert tops._group_modes(np.int32(m), w) == m
    assert torch.equal(tops._group_modes(mode_t, w), mode_t)
    res = []
    for mode in (m, mode_t):
        wt = w.clone().requires_grad_(True)
        out = tops.uniq_transform_onchip(wt, mu, sd, mode, key, k=16)
        (out * g).sum().backward()
        res.append((out.detach(), wt.grad))
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])
    with pytest.raises(ValueError):
        tun.uniq_noise_fwd_onchip(w, mu, sd, 3, key, k=16)
    with pytest.raises(ValueError):
        tun.uniq_noise_bwd(g, w, a, mu, sd, -1)


def _rng_normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)
