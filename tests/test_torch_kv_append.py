"""PyTorch port vs JAX reference: the serving engine's coded KV append.

``models/kv_cache.py:append_kv`` codes a layer's fresh K/V rows and writes
codes and bf16 statistics into the paged pool; on the card that is one
``kv_append`` kernel launch (``kernels/kquantile.py``), on the CPU its plain
version ``kv_append_plain``.  Here, on the CPU: the append against the
reference's ``quantize_kv`` + ``.at[pages, rows].set`` on the ``*_smoke``
configs' pools, under the bounds ``test_torch_codec.py::test_quantize_kv``
pins; bit for bit against the append as ``lm._write_rows`` ran it before the
fused kernel; pool bytes outside the destinations untouched; what the
wrapper refuses, destinations outside the pool included; its launch
counter.  The kernel itself is held against the
plain version on the card by ``chip_smoke.py`` phase 3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import kv_cache as jkv

from repro_torch.configs import base as tcb
from repro_torch.core import packing as tpack
from repro_torch.kernels import kquantile as tkq
from repro_torch.kernels import ops as tops
from repro_torch.models import kv_cache as tkv
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


ARCHS = ("granite_3_8b", "gemma2_9b", "yi_6b")
PAGE = 8
LEAVES = tkq.KV_LEAVES

# As test_torch_codec.py::test_quantize_kv: a statistic reduced in another
# order may land one bf16 ulp away (mu absolute 2^-8, sigma relative
# 2^-7, at most 5e-3 of sigmas differing); codes flip only at bin edges
# (at most 5e-4 of them, never by more than one code).
MU_ATOL = 2.0 ** -8
SIGMA_RTOL = 2.0 ** -7
SIGMA_MISMATCH = 5e-3
KV_CODE_MISMATCH = 5e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _pool_layer(cfg, kv_bits, total_pages, seed):
    """One layer view of a port pool (``init_paged_cache``) filled with
    random bytes, so a byte the append must not touch is recognisable."""
    cache = tlm.init_paged_cache(cfg, total_pages, PAGE, kv_bits=kv_bits,
                                 device="cpu")
    r = _rng(seed)
    for leaf in cache.values():
        if leaf.dtype == torch.bfloat16:
            vals = r.uniform(0.1, 1.1, size=leaf.shape).astype(np.float32)
            leaf.copy_(torch.from_numpy(vals).to(torch.bfloat16))
        else:
            vals = r.integers(0, 256, size=leaf.shape).astype(np.uint8)
            leaf.copy_(torch.from_numpy(vals).view(leaf.dtype))
    return cache, {name: leaf[1] for name, leaf in cache.items()}


def _rows(cfg, lead, seed):
    """K and V rows (*lead, KV, hd) with per-row offsets and scales."""
    r = _rng(seed)
    shape = (*lead, cfg.n_kv_heads, cfg.head_dim)

    def one():
        scale = r.uniform(0.5, 1.5, size=(*shape[:-1], 1))
        off = r.normal(0.0, 0.2, size=(*shape[:-1], 1))
        return (r.standard_normal(shape) * scale + off).astype(np.float32)
    return one(), one()


def _destinations(n, total_pages, seed):
    """(n,) pages / rows: distinct slots of pages >= 1 with the pool's
    last row (a page's last row) among them; every third row a pad row on
    the sink page 0, rows 0 and 1 repeated."""
    r = _rng(seed)
    slots = r.permutation((total_pages - 1) * PAGE)[:n] + PAGE
    last = total_pages * PAGE - 1
    slots[slots == last] = slots[0]
    slots[0] = last
    pages, rows = slots // PAGE, slots % PAGE
    pad = np.arange(n)[np.arange(n) % 3 == 2]
    pages[pad] = 0
    rows[pad] = pad % 2
    return pages.astype(np.int64), rows.astype(np.int64)


def _old_write_rows_body(view, pages, rows, k, v, kv_bits):
    """The coded branch of ``lm._write_rows`` before the fused append: both
    blocks coded in one ``quantize_kv`` pass, then six index writes."""
    st, mu, sig = tkv.quantize_kv(torch.stack([k, v]), kv_bits)
    vals = {"k_codes": st[0], "k_mu": mu[0], "k_sigma": sig[0],
            "v_codes": st[1], "v_mu": mu[1], "v_sigma": sig[1]}
    for name, val in vals.items():
        view[name][pages, rows] = val.to(view[name].dtype)


def _to_jax(leaf):
    """A JAX copy of a pool leaf.  ``jnp.asarray`` of a 64-byte aligned
    torch buffer is zero-copy on the CPU (JAX then takes the memory as
    immutable), and the append writes this very pool in place afterwards:
    copy, so the reference never reads memory the port mutates."""
    if leaf.dtype == torch.bfloat16:
        return jnp.array(leaf.float().numpy(), copy=True).astype(
            jnp.bfloat16)
    return jnp.array(leaf.numpy(), copy=True)


def _codes_close(cj, ct, bound, stats=None):
    """Codes (rows, heads, hd) at most one bin apart and at most ``bound``
    of them apart.  ``stats`` ({name: (rows, heads) array}, both sides'
    bf16 mu / sigma) goes into the failure message, row by row."""
    d = np.abs(cj.astype(np.int64) - ct.astype(np.int64))
    bad = np.argwhere((d > 0).any(axis=-1))
    where = "; ".join(
        f"row {r} head {h}: {int((d[r, h] > 0).sum())} codes, "
        + ", ".join(f"{n} {float(v[r, h])!r}" for n, v in stats.items())
        for r, h in bad[:4]) if stats else ""
    assert d.max() <= 1, f"a code is off by more than one bin: {where}"
    assert (d > 0).mean() <= bound, \
        f"mismatch rate {(d > 0).mean():.2e}: {where}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_append_matches_reference(arch, kv_bits):
    """``append_kv`` on a decode block (B, KV, hd) against the reference's
    ``quantize_kv`` of K and of V and its ``.at[pages, rows].set`` of the
    six leaves, on the same starting pool; the sink page is excluded (its
    repeated rows land in no set order)."""
    _check_against_reference(tcb.get_smoke(arch), kv_bits)


@pytest.mark.parametrize("hd", [20, 112, 160])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_append_matches_reference_at_other_head_dims(hd, kv_bits):
    """As above at the head dims of stablelm_12b (160, smoke 20) and
    kimi_k2 (112), which the fused kernel takes by ``append_layout``."""
    cfg = dataclasses.replace(tcb.get_smoke("granite_3_8b"), head_dim=hd)
    _check_against_reference(cfg, kv_bits)


@pytest.mark.parametrize("hd", [7, 33])
def test_append_matches_reference_at_odd_head_dims(hd):
    """An odd head_dim at kv8, which the reference codes (its
    ``check_kv_bits`` refuses one only at kv4): the append, by
    ``append_layout``'s one-value chunks, against the reference."""
    cfg = dataclasses.replace(tcb.get_smoke("granite_3_8b"), head_dim=hd)
    _check_against_reference(cfg, 8)


def _check_against_reference(cfg, kv_bits):
    P, n = 9, 40
    _, view = _pool_layer(cfg, kv_bits, P, seed=1)
    ref = {name: _to_jax(leaf) for name, leaf in view.items()}
    k, v = _rows(cfg, (n,), seed=2)
    pages, rows = _destinations(n, P, seed=3)
    tkv.append_kv(view, torch.from_numpy(pages), torch.from_numpy(rows),
                  torch.from_numpy(k), torch.from_numpy(v), kv_bits)
    for side, x in (("k", k), ("v", v)):
        st, mu, sg = jkv.quantize_kv(jnp.asarray(x), kv_bits)
        for name, val in (("codes", st), ("mu", mu), ("sigma", sg)):
            leaf = f"{side}_{name}"
            ref[leaf] = ref[leaf].at[pages, rows].set(
                val.astype(ref[leaf].dtype))
    real = pages != 0
    pr, rr = pages[real], rows[real]
    for side in ("k", "v"):
        mt = view[f"{side}_mu"].float().numpy()[pr, rr]
        mj = np.asarray(ref[f"{side}_mu"].astype(jnp.float32))[pr, rr]
        gt = view[f"{side}_sigma"].float().numpy()[pr, rr]
        gj = np.asarray(ref[f"{side}_sigma"].astype(jnp.float32))[pr, rr]
        np.testing.assert_allclose(mt, mj, atol=MU_ATOL)
        np.testing.assert_allclose(gt, gj, rtol=SIGMA_RTOL)
        assert (gt != gj).mean() < SIGMA_MISMATCH
        ct = view[f"{side}_codes"].numpy()[pr, rr]
        cj = np.asarray(ref[f"{side}_codes"])[pr, rr]
        if kv_bits == 4:
            ct = tpack.unpack_int4(torch.from_numpy(ct)).numpy()
            cj = tpack.unpack_int4(torch.from_numpy(cj)).numpy()
        _codes_close(cj, ct, KV_CODE_MISMATCH,
                     {"port mu": mt, "ref mu": mj, "port sigma": gt,
                      "ref sigma": gj})
    # every slot the append did not target holds the reference's (= the
    # starting pool's) bytes on both sides
    untouched = np.ones((P, PAGE), bool)
    untouched[pages, rows] = False
    for name, leaf in view.items():
        want = np.asarray(ref[name].astype(jnp.float32)) \
            if leaf.dtype == torch.bfloat16 else np.asarray(ref[name])
        got = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.numpy()
        np.testing.assert_array_equal(got[untouched], want[untouched])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("lead", [(6,), (3, 5)], ids=["decode", "chunk"])
def test_append_is_the_old_write_rows_body(arch, kv_bits, lead):
    """Bit for bit the append ``lm._write_rows`` made before the fused
    kernel, for a decode block (B,) and a prefill chunk's (B, C) rows, and
    ``_write_rows`` itself on a whole cache; pool bytes outside the
    destinations untouched."""
    cfg = tcb.get_smoke(arch)
    P = 9
    n = int(np.prod(lead))
    k, v = (torch.from_numpy(x) for x in _rows(cfg, lead, seed=4))
    pages, rows = (torch.from_numpy(x).reshape(lead)
                   for x in _destinations(n, P, seed=5))
    cache, view = _pool_layer(cfg, kv_bits, P, seed=6)
    start = {name: leaf.clone() for name, leaf in view.items()}
    old = {name: leaf.clone() for name, leaf in view.items()}
    tkv.append_kv(view, pages, rows, k, v, kv_bits)
    _old_write_rows_body(old, pages, rows, k, v, kv_bits)
    target = torch.zeros((P, PAGE), dtype=torch.bool)
    target[pages, rows] = True
    for name in LEAVES:
        assert torch.equal(view[name][1:], old[name][1:]), name
        assert torch.equal(view[name][~target], start[name][~target]), name
    # through the model's own entry: layer 1 of the cache, in place
    again, _ = _pool_layer(cfg, kv_bits, P, seed=6)
    out = tlm._write_rows(again, 1, pages, rows, k, v, kv_bits)
    for name in LEAVES:
        assert torch.equal(again[name][1, 1:], view[name][1:]), name
        assert torch.equal(again[name][0], cache[name][0]), name
        assert out[name].data_ptr() == again[name][1].data_ptr()


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_use_kernel_false_is_the_plain_version(kv_bits):
    """``use_kernel=False`` (the comparison hook) and the wrapper's CPU
    path are one computation: ``kv_append_plain``."""
    cfg = tcb.get_smoke("granite_3_8b")
    k, v = (torch.from_numpy(x) for x in _rows(cfg, (7,), seed=7))
    pages, rows = (torch.from_numpy(x) for x in _destinations(7, 5, seed=8))
    _, a = _pool_layer(cfg, kv_bits, 5, seed=9)
    _, b = _pool_layer(cfg, kv_bits, 5, seed=9)
    tkv.append_kv(a, pages, rows, k, v, kv_bits, use_kernel=False)
    tkq.kv_append(b, pages, rows, k, v, kv_bits=kv_bits)
    for name in LEAVES:
        assert torch.equal(a[name][1:], b[name][1:]), name


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cfg = tcb.get_smoke("granite_3_8b")
    k, v = (torch.from_numpy(x) for x in _rows(cfg, (4,), seed=10))
    pages, rows = (torch.from_numpy(x) for x in _destinations(4, 5, seed=11))
    _, view = _pool_layer(cfg, 8, 5, seed=12)

    def call(pool=view, p=pages, r=rows, kk=k, vv=v, bits=8):
        tkq.kv_append(pool, p, r, kk, vv, kv_bits=bits)

    call()
    with pytest.raises(TypeError):
        call(kk=k.half(), vv=v.half())                    # not f32 / bf16
    with pytest.raises(TypeError):
        call(vv=v.to(torch.bfloat16))                      # k and v differ
    with pytest.raises(ValueError):
        call(p=pages.to(torch.int32))                      # not int64
    with pytest.raises(ValueError):
        call(r=rows[:3])                                   # not (N,)
    with pytest.raises(ValueError):
        call(bits=4)                                       # kv8 leaves
    with pytest.raises(ValueError):
        call(bits=16)
    with pytest.raises(ValueError):
        call(pool=dict(view, k_mu=view["k_mu"].float()))   # stats not bf16
    with pytest.raises(ValueError):
        call(pool={n: t for n, t in view.items() if n != "v_sigma"})
    strided = view["k_codes"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        call(pool=dict(view, k_codes=strided))             # not contiguous
    with pytest.raises(ValueError):
        call(kk=k.transpose(0, 1).contiguous().transpose(0, 1))
    # kv4 packs two codes a byte: an odd head_dim is refused
    odd = torch.zeros((4, cfg.n_kv_heads, 15))
    with pytest.raises(ValueError):
        tkq.kv_append({n: t[..., :7] if n.endswith("codes") else t
                       for n, t in _pool_layer(cfg, 4, 5, seed=13)[1].items()},
                      pages, rows, odd, odd, kv_bits=4)
    with pytest.raises(ValueError):
        tkv.check_kv_bits(4, 15)


@pytest.mark.parametrize("where", ["page<0", "row<0", "page>=P", "row>=page"])
def test_destinations_outside_the_pool_are_refused(where):
    """The kernel traps on a destination outside [0, P) x [0, page); the
    plain version refuses the same ones (a negative index is not wrapped to
    the pool's end) and leaves the pool as it was."""
    cfg = tcb.get_smoke("granite_3_8b")
    P = 5
    k, v = (torch.from_numpy(x) for x in _rows(cfg, (4,), seed=17))
    pages, rows = (torch.from_numpy(x) for x in _destinations(4, P, seed=18))
    bad = {"page<0": (0, -1), "row<0": (1, -1),
           "page>=P": (0, P), "row>=page": (1, PAGE)}[where]
    (pages if bad[0] == 0 else rows)[1] = bad[1]
    _, view = _pool_layer(cfg, 8, P, seed=19)
    start = {name: leaf.clone() for name, leaf in view.items()}
    # a negative index fails the plain version's assertion (RuntimeError on
    # the CPU); one past the end fails the index write (IndexError)
    with pytest.raises(RuntimeError if bad[1] < 0 else IndexError):
        tkv.append_kv(view, pages, rows, k, v, 8)
    if bad[1] < 0:
        for name in LEAVES:
            assert torch.equal(view[name], start[name]), name


def test_launch_counter_counts_only_kernel_launches():
    cfg = tcb.get_smoke("granite_3_8b")
    k, v = (torch.from_numpy(x) for x in _rows(cfg, (4,), seed=14))
    pages, rows = (torch.from_numpy(x) for x in _destinations(4, 5, seed=15))
    _, view = _pool_layer(cfg, 8, 5, seed=16)
    before = tops.launch_counts()
    assert "kv_append" in before
    tkv.append_kv(view, pages, rows, k, v, 8)
    tkq.kv_append(view, pages, rows, k, v, kv_bits=8)
    assert tops.launch_counts() == before                 # CPU: no launch


def test_head_dims_the_kernel_takes_cover_the_configs():
    """Every head_dim of the reference's registry (full and small configs)
    is one the fused kernel takes, so no model it serves meets a refusal on
    the card; mamba2 (family "ssm") has no attention and no KV pool."""
    for arch in jcb.ARCH_IDS:
        for get in (jcb.get, jcb.get_smoke):
            cfg = get(arch)
            if cfg.family == "ssm":
                continue
            vpl, lanes = tkq.append_layout(cfg.head_dim)
            assert cfg.head_dim % vpl == 0 and lanes <= 32, arch


@pytest.mark.parametrize("hd", range(2, tkq.KV_APPEND_MAX_HD + 1, 2))
def test_append_layout(hd):
    """The fixed rule for every even head_dim: whole chunks of 2, 4 or 8
    values, the fewest lanes (a power of two, at most 32) that cover them,
    and no more chunks a lane than the kernel has a body for (4 at VPL 2,
    2 at VPL 4, 1 at VPL 8); the head dims of the first kernel keep its
    layout."""
    vpl, lanes = tkq.append_layout(hd)
    chunks = hd // vpl
    assert vpl in (2, 4, 8) and hd % vpl == 0
    assert lanes & (lanes - 1) == 0 and lanes <= 32
    assert lanes >= min(chunks, 32) and (lanes == 1 or lanes < 2 * chunks)
    assert -(-chunks // lanes) <= {2: 4, 4: 2, 8: 1}[vpl]
    if chunks > 32:
        assert not any(hd % v == 0 and hd // v <= 32 for v in (2, 4, 8))
    first = {16: (4, 4), 32: (4, 8), 64: (4, 16), 128: (4, 32),
             256: (8, 32)}
    if hd in first:
        assert (vpl, lanes) == first[hd]


@pytest.mark.parametrize("hd", [0, 257, 258, 512])
def test_append_layout_refuses_odd_and_wide_head_dims(hd):
    """A head_dim of 0 or above 256, odd or even, is refused, on the card,
    before any launch."""
    with pytest.raises(ValueError):
        tkq.append_layout(hd)


@pytest.mark.parametrize("hd", [1, 15, 161])
def test_append_layout_of_odd_head_dims(hd):
    """An odd head_dim (kv8 only) takes one value a chunk: the fewest lanes
    (a power of two, at most 32) that cover the chunks, at most 8 chunks a
    lane (the kernel's bodies at VPL 1), and the scalar loads and stores
    whatever the pointers."""
    vpl, lanes = tkq.append_layout(hd)
    assert vpl == 1
    assert lanes & (lanes - 1) == 0 and min(hd, 32) <= lanes <= 32
    assert lanes == 1 or lanes < 2 * hd
    assert -(-hd // lanes) <= 8
    for itemsize in (2, 4):
        assert tkq.append_route(hd, itemsize, 8) == (tkq.SCALAR, tkq.SCALAR)


@pytest.mark.parametrize("hd,itemsize,kv_bits,vals,codes,want", [
    (128, 2, 8, (0, 256), (512, 1024), ("vector", "vector")),
    (128, 4, 4, (0, 512), (0, 64), ("vector", "vector")),
    (20, 2, 8, (0, 40), (0, 20), ("scalar", "scalar")),      # 40 B rows
    (20, 4, 8, (0, 80), (0, 20), ("vector", "scalar")),      # 80 B rows
    (112, 2, 4, (0, 224), (0, 56), ("vector", "scalar")),    # 56 B codes
    (160, 2, 4, (0, 320), (0, 80), ("vector", "vector")),
    (16, 2, 4, (0, 32), (0, 8), ("vector", "scalar")),
    (128, 2, 8, (8, 256), (0, 128), ("scalar", "vector")),   # k off 16 B
    (128, 2, 8, (0, 256), (0, 136), ("vector", "scalar")),   # v codes off
])
def test_append_route(hd, itemsize, kv_bits, vals, codes, want):
    assert tkq.append_route(hd, itemsize, kv_bits, vals, codes) == want
