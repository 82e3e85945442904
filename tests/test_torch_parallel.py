"""PyTorch port vs JAX reference: the multi-device layer's rules and codecs
in one process (the gloo worlds are ``tests/test_torch_distributed.py``).

* ``param_rule_spec`` and the fitted spec of every leaf of every registered
  arch's raw, W4 Gaussian and W4 empirical smoke trees, for fsdp True /
  False / "pod", expert_mode gather / reduce, tp True / False, on meshes
  (1, 1), (16, 16) and (2, 16, 16) (the reference's rules read only the
  mesh's shape and axis names: an abstract mesh on its side, a
  ``MeshShape`` on the port's);
* ``cache_shardings``' specs of every family's decode cache;
* each rank's block of a dim split over several mesh axes is the one JAX's
  ``NamedSharding`` gives that device (the spec's axis tuple major first,
  whatever the mesh's order), and ``placements`` refuses such a dim only
  where ``Shard`` placements cannot order its blocks so;
* ``_absmax_quant``'s codes and scales bit-equal to the reference's (.5
  ties rounded half to even on both sides, an all-zero 1-D leaf at the
  1e-30 floor, a 3-D bf16 leaf);
* the local-expert rule: each shard's MoE contribution equal to the
  reference's ``moe_ffn_local(shard_idx=i, n_shards=n)`` for n = 2 and 4,
  dense and W4 weights, with copies dropped;
* the compile audit's sharding coverage: 0 findings, the reference's
  ``sharded_leaves`` and ``rules_hit``;
* what needs no world: the MoE config under ``dp_compress_bits`` raises the
  reference's message; the mesh factories raise on a world too small.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.analysis import compile_audit as jaudit
from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jshd
from repro.train import steps as jsteps

from repro_torch import tree as tree_lib
from repro_torch.analysis import compile_audit as taudit
from repro_torch.configs import base as tcb
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel import sharding as tshd
from repro_torch.train import steps as tsteps

import test_torch_distributed as tdist
import test_torch_moe as tmoe_test


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread for this module, restored after it: at
    these sizes more threads only add their OpenMP spin-waits, which take
    the cores of the suite's other parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the MoE FFN at f32 (tests/test_torch_moe.py's TOL_F32)
TOL_F32 = tmoe_test.TOL_F32


def _meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            tshd.MeshShape(tuple(zip(axes, shape))))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """{variant: [(path, shape)]} of the port's raw, W4 Gaussian and W4
    empirical smoke trees (leaf for leaf the reference's: the coverage
    test below holds their counts to the reference's)."""
    cfg = tcb.get_smoke(arch)
    out = {}
    for variant, kw in (("raw", {}), ("w4/gaussian", {"w_bits": 4}),
                        ("w4/empirical", {"w_bits": 4,
                                          "w_dist": "empirical"})):
        tree = tmodel.init(0, cfg, device="cpu", **kw)
        out[variant] = [(p, tuple(v.shape))
                        for p, v in tree_lib.leaves_with_paths(tree)]
    return out


def _nest(flat):
    return tdist._nest(flat)


@functools.lru_cache(maxsize=None)
def _metas(arch, variant):
    """The tree of ``meta`` tensors of one of ``_trees``' variants."""
    return _nest({p: torch.empty(s, device="meta")
                  for p, s in _trees(arch)[variant]})


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    """Every leaf's rule and fitted spec in every combination (the
    reference's fitted spec is its ``param_shardings``' own composition,
    ``_fit`` of the rule's spec, through ``_drop_tp`` without tensor
    parallelism); the whole ``param_shardings`` tree once a variant and
    mesh."""
    cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
    for variant, leaves in _trees(arch).items():
        for name in MESHES:
            jm, tm = _meshes(name)
            for fsdp in (True, False, "pod"):
                for mode in ("gather", "reduce"):
                    got = {tp: tree_lib.leaves(tshd.param_shardings(
                        _metas(arch, variant), cfg_t, tm, fsdp, mode, tp))
                        for tp in (True, False)}
                    for i, (p, s) in enumerate(leaves):
                        rj, sj = jshd.param_rule_spec(p, s, cfg_j, fsdp, jm,
                                                      mode)
                        rt, st = tshd.param_rule_spec(p, s, cfg_t, fsdp, tm,
                                                      mode)
                        assert (rt, tuple(st)) == (rj, tuple(sj)), \
                            (arch, variant, name, fsdp, mode, p)
                        for tp in (True, False):
                            want = jshd._fit(sj if tp else jshd._drop_tp(sj),
                                             s, jm)
                            assert tuple(got[tp][i].spec) == tuple(want), \
                                (arch, variant, name, fsdp, mode, tp, p)
            want = jax.tree_util.tree_leaves(jshd.param_shardings(
                _nest({p: jax.ShapeDtypeStruct(s, jnp.float32)
                       for p, s in leaves}), cfg_j, jm, "pod", "reduce",
                False))
            got = tree_lib.leaves(tshd.param_shardings(
                _metas(arch, variant), cfg_t, tm, "pod", "reduce", False))
            assert [tuple(g.spec) for g in got] == \
                [tuple(w.spec) for w in want], (arch, variant, name)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_input_specs_equal_the_reference(mesh):
    jm, tm = _meshes(mesh)
    for arch in ("granite_3_8b", "mamba2_1_3b", "zamba2_2_7b",
                 "whisper_base"):
        cfg_j, cfg_t = jcb.get_smoke(arch), tcb.get_smoke(arch)
        for B in (1, 16, 32, 6):
            specs = tmodel.cache_specs(cfg_t, B, 64)
            shapes = jax.tree.map(
                lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
                specs, is_leaf=lambda x: isinstance(x, torch.Tensor))
            want = jax.tree_util.tree_leaves(
                jshd.cache_shardings(cfg_j, shapes, jm))
            got = tree_lib.leaves(tshd.cache_shardings(cfg_t, specs, tm))
            assert [tuple(g.spec) for g in got] == \
                [tuple(w.spec) for w in want], (arch, B)
            for include_model in (False, True):
                batch = {"tokens": torch.empty((B, 8), device="meta")}
                want = jshd.input_shardings(
                    {"tokens": jax.ShapeDtypeStruct((B, 8), jnp.int32)}, jm,
                    include_model)["tokens"].spec
                got = tshd.input_shardings(batch, tm,
                                           include_model)["tokens"].spec
                assert tuple(got) == tuple(want), (arch, B, include_model)


@pytest.mark.parametrize("spec", [
    (("data", "pod"), None), (None, ("data", "model")),
    (("pod", "data"), "model"), (("data", "pod", "model"), None),
    ("model", ("data", "pod")), (("model", "pod"), "data")])
def test_blocks_of_multi_axis_dims_follow_jax(spec):
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    jm = AbstractMesh(shape, axes)
    tm = tshd.MeshShape(tuple(zip(axes, shape)))
    js = NamedSharding(jm, JP(*spec))
    ts = tshd.Sharding(tm, tshd.P(*spec))
    x = (8, 16)
    for r in range(8):
        coords = dict(zip(axes, np.unravel_index(r, shape)))
        assert ts.block(x, coords) == tdist.jax_block(js, x, r), (spec, r)
    in_order = all(
        [axes.index(a) for a in (e if isinstance(e, tuple) else (e,))]
        == sorted(axes.index(a) for a in (e if isinstance(e, tuple)
                                          else (e,)))
        for e in spec if e is not None)
    if in_order:
        from torch.distributed.tensor import Replicate, Shard
        got = tshd.placements(tshd.P(*spec), tm)
        for a, pl in zip(axes, got):
            dims = [i for i, e in enumerate(spec) if e is not None
                    and a in (e if isinstance(e, tuple) else (e,))]
            assert pl == (Shard(dims[0]) if dims else Replicate()), (a, pl)
    else:
        with pytest.raises(ValueError, match="against the mesh's axis"):
            tshd.placements(tshd.P(*spec), tm)


def _codec_leaves():
    rng = np.random.default_rng(0)
    ties = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 4.0]],
                    np.float32)                       # scale 1: .5 ties
    return {"ties": np.concatenate([ties, ties * 0.5]),
            "zeros": np.zeros((200,), np.float32),           # 1-D, floor
            "bf16": (rng.standard_normal((3, 8, 16)) * 1e-3).astype(
                ml_dtypes.bfloat16)}                          # 3-D


@pytest.mark.parametrize("bits", [8, 4])
def test_absmax_quant_is_bit_equal_to_the_reference(bits):
    for name, g in _codec_leaves().items():
        cj, sj = tdist._ref_quant(jnp.asarray(g), jnp.int32(bits))
        t = torch.from_numpy(g.view(np.uint16).astype(np.int32) << 16).view(
            torch.float32).to(torch.bfloat16) if g.dtype == \
            ml_dtypes.bfloat16 else torch.from_numpy(g)
        ct, st = tcoll._absmax_quant(t, bits)
        assert ct.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj),
                                      err_msg=name)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj),
                                      err_msg=name)
    ct, _ = tcoll._absmax_quant(torch.from_numpy(_codec_leaves()["ties"]))
    # round half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 1.5 -> 2
    assert ct[0, 1:6].tolist() == [2, -4, 0, 0, 2]


# the local-expert case: 48 tokens, top-2 of 8 experts, a capacity that
# drops about a quarter of the copies
LE_T, LE_D, LE_F, LE_E, LE_K = 48, 32, 24, 8, 2


@functools.lru_cache(maxsize=None)
def _le_inputs(coded):
    """x, router, the three stacks as the port takes them, and their dense
    values as the reference's ``materialize`` gives them."""
    x = tmoe_test._x(LE_T, LE_D, 1)
    router = tmoe_test._router(LE_D, LE_E, 2)
    stacks = [tmoe_test._stack(LE_E, LE_D, LE_F, 3),
              tmoe_test._stack(LE_E, LE_D, LE_F, 4),
              tmoe_test._stack(LE_E, LE_F, LE_D, 5)]
    if not coded:
        return x, router, stacks, stacks
    # tests/test_torch_moe.py's _coded (a stacked layer leaf's W4 codes,
    # layer 0 sliced off) and the reference's dequant, each compiled once
    quant = jax.jit(lambda w: jlm.quantize_params_for_serving(
        {"layers": {"eg": w[None]}}, 4)["layers"]["eg"])
    deq = jax.jit(lambda c: jlm.materialize(c, jnp.float32))
    codes = [{k: np.asarray(v)[0] for k, v in quant(jnp.asarray(w)).items()}
             for w in stacks]
    dense = [np.asarray(deq(tmoe_test._j(c))) for c in codes]
    return x, router, codes, dense


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("coded", [False, True])
def test_local_expert_rule_matches_reference(n, coded):
    x, router, ws, dense = _le_inputs(coded)
    cf = tmoe_test._dropping_cf(LE_T, LE_K, LE_E)
    cfg_j, cfg_t = jmoe.MoEConfig(LE_E, LE_K, cf), tmoe.MoEConfig(LE_E,
                                                                  LE_K, cf)
    ref = jax.jit(functools.partial(jmoe.moe_ffn_local, cfg=cfg_j,
                                    n_shards=n))
    E_l = LE_E // n
    dropped = 0
    total = np.zeros((LE_T, LE_D), np.float32)
    for i in range(n):
        sl = slice(i * E_l, (i + 1) * E_l)
        want = np.asarray(ref(jnp.asarray(x), jnp.asarray(router),
                              *[jnp.asarray(w[sl]) for w in dense],
                              shard_idx=i))
        local = [dict(tmoe_test._t(c), q_codes=tmoe_test._t(c)["q_codes"][sl])
                 for c in ws] if coded \
            else [torch.from_numpy(w[sl]) for w in ws]
        got = tmoe.moe_ffn_local(torch.from_numpy(x), torch.from_numpy(router),
                                 *local, cfg_t, shard_idx=i, n_shards=n)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32,
                                   err_msg=f"shard {i} of {n}")
        r = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), cfg_t,
                       i, E_l)
        assert r["rows"].shape == (E_l,)
        dropped += int((r["expert"] < E_l).sum() - r["keep"].sum())
        total += got.numpy()
    assert dropped > 0                        # the capacity binds
    whole = tmoe.moe_ffn_local(
        torch.from_numpy(x), torch.from_numpy(router),
        *([tmoe_test._t(c) for c in ws] if coded
          else [torch.from_numpy(w) for w in ws]), cfg_t)
    np.testing.assert_allclose(total, whole.numpy(), atol=TOL_F32)


def test_sharding_coverage_equals_the_reference():
    findings, info = taudit.check_sharding_coverage(device="cpu")
    jf, jinfo = jaudit.check_sharding_coverage()
    assert findings == [] and jf == []
    assert info == {"sharded_leaves": jinfo["sharded_leaves"],
                    "rules_hit": jinfo["rules_hit"]}


def test_moe_with_dp_compress_raises_the_reference_message():
    mesh = tshd.MeshShape((("pod", 1),))
    opts = tlm.ModelOpts(mesh=mesh)
    tc = tsteps.TrainConfig(dp_compress_bits=8)
    with pytest.raises(NotImplementedError) as got:
        tsteps.make_train_step(tcb.get_smoke("kimi_k2_1t_a32b"), opts, tc)
    jm = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("pod",))
    with pytest.raises(NotImplementedError) as want:
        jsteps.make_train_step(
            jcb.get_smoke("kimi_k2_1t_a32b"),
            jlm.ModelOpts(mesh=jm), jsteps.TrainConfig(dp_compress_bits=8))
    assert str(got.value) == str(want.value)
    # without the pod axis a MoE config builds
    tsteps.make_train_step(tcb.get_smoke("kimi_k2_1t_a32b"), tlm.ModelOpts(),
                           tc)


def test_mesh_factories_need_the_world(monkeypatch):
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 4)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks; the world "
                                             f"has 4"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.init_world(store_path="x", rank=0, world_size=1)
    # the single-rank case: dense models on a one-rank mesh are not refused
    tmodel.require_mesh_ported(tcb.get_smoke("granite_3_8b"), tlm.ModelOpts(
        mesh=tshd.MeshShape((("data", 1), ("model", 1)))), "loss_fn")
    # past one rank a dense model needs its parameters placed, and a
    # state-space model is not ported
    with pytest.raises(ValueError, match="needs its parameters placed"):
        tmodel.require_mesh_ported(
            tcb.get_smoke("yi_6b"), tlm.ModelOpts(mesh=tshd.MeshShape(
                (("data", 2), ("model", 1)))), "decode")
    with pytest.raises(NotImplementedError, match="not ported"):
        tmodel.require_mesh_ported(
            tcb.get_smoke("mamba2_1_3b"), tlm.ModelOpts(mesh=tshd.MeshShape(
                (("data", 2), ("model", 1)))), "decode")
