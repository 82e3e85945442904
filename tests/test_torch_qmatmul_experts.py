"""The expert body's host-side rules (``kernels/qmatmul.py``).

``qmatmul_experts`` / ``qmatmul_lut_experts`` with bf16 activations at W4
run ``qmatmul_experts_wg_kernel`` (``csrc/qmatmul.cu``): a persistent grid
that walks the (expert in use, row block, column block) tiles.  The kernel
itself runs only on the card (``chip_smoke.py`` phase 3 holds it against
its plain version); here, on the CPU: its plan is a function of the shapes
and the SM count only, a decode step's capacity takes the 8-row tile, and
the walk (``expert_tiles``, the kernel's order written in Python) takes
every tile of the experts in use exactly once and no tile of an idle
expert.  The plain versions themselves are held against the reference's
``materialize`` + ``einsum`` in ``test_torch_moe.py``.
"""

import numpy as np
import pytest

from repro.models import moe as jmoe

from repro_torch.configs import base as tcb
from repro_torch.kernels import qmatmul as tqmm
from repro_torch.models import moe as tmoe

H100_SMS = 132

# (E, C, K, N): the engine's calls at kimi_k2's and llama4's widths
# (decode, a 256- and a 1024-token prefill), and ragged shapes
SHAPES = [(384, 8, 7168, 2048), (384, 8, 2048, 7168), (384, 16, 7168, 2048),
          (384, 32, 2048, 7168), (128, 8, 5120, 8192), (128, 16, 8192, 5120),
          (5, 24, 200, 130), (3, 33, 520, 96), (4, 128, 512, 384),
          (2, 1, 64, 2), (1, 16, 2048, 1024), (6, 300, 256, 258)]


@pytest.mark.parametrize("E,C,K,N", SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
def test_plan_is_a_function_of_the_shapes_and_sms(E, C, K, N, sms):
    """Tile rows, row blocks, the persistent grid (the SM count times the
    blocks an SM holds at that tile) and the split count (1) follow from
    (E, C, K, N) and the SM count; nothing about which experts are in use
    enters, so it is the same for any ``rows``."""
    plan = tqmm.expert_plan(E, C, K, N, sms)
    assert plan == tqmm.expert_plan(E, C, K, N, sms)
    bm = plan["bm"]
    assert bm in tqmm.EXPERT_TILES
    assert plan["row_blocks"] == -(-C // bm)
    assert plan["grid"] == sms * tqmm.EXPERT_BLOCKS_PER_SM[bm]
    assert plan["splits"] == 1
    # the smallest tile that holds C, the widest where none does
    assert bm >= C or bm == tqmm.EXPERT_TILES[-1]
    smaller = [t for t in tqmm.EXPERT_TILES if t < bm]
    assert not smaller or smaller[-1] < C
    # the walk's tile count over every expert in use is the plan's
    rows = np.full(E, C)
    tiles = tqmm.expert_tiles(rows, C, N, bm, plan["grid"])
    assert sum(map(len, tiles)) == E * plan["row_blocks"] * -(-N // 128)


@pytest.mark.parametrize("C", range(1, 9))
def test_a_capacity_of_eight_rows_or_fewer_takes_the_8_row_tile(C):
    assert tqmm.expert_tile(C) == 8
    assert tqmm.expert_plan(384, C, 7168, 2048, H100_SMS)["bm"] == 8


@pytest.mark.parametrize("arch,T", [("kimi_k2_1t_a32b", 16),
                                    ("kimi_k2_1t_a32b", 256),
                                    ("llama4_maverick_400b_a17b", 16),
                                    ("llama4_maverick_400b_a17b", 256)])
def test_the_engines_decode_and_short_prefill_take_the_8_row_tile(arch, T):
    """A decode step of 16 tokens and a prefill call of up to 256 routes
    C = 8 rows an expert at both MoE configs (capacity factor 1.25), the
    reference's capacity as the port's, so the 8-row tile serves them."""
    c = tcb.get(arch)
    cfg = tmoe.MoEConfig(c.n_experts, c.top_k, c.capacity_factor)
    C = tmoe.capacity(T, cfg)
    assert C == jmoe.capacity(T, jmoe.MoEConfig(
        c.n_experts, c.top_k, c.capacity_factor))
    assert C <= 8 and tqmm.expert_tile(C) == 8


def _rows(kind, E, C, seed):
    r = np.random.default_rng(seed)
    if kind == "none":
        return np.zeros(E, np.int64)
    if kind == "all":
        return r.integers(1, C + 1, E)
    rows = np.where(r.random(E) < 0.3, r.integers(1, C + 1, E), 0)
    rows[r.integers(0, E)] = C + 5            # clamped to C, as the kernel
    rows[r.integers(0, E)] = -3               # clamped to 0: idle
    return rows


@pytest.mark.parametrize("kind", ["none", "all", "some"])
@pytest.mark.parametrize("E,C,N", [(384, 8, 2048), (128, 16, 8192),
                                   (1, 8, 1024), (5, 24, 130),
                                   (3, 300, 96), (16, 64, 1024)])
@pytest.mark.parametrize("grid", [396, 7, 1])
def test_the_walk_takes_each_tile_of_the_experts_in_use_once(kind, E, C, N,
                                                            grid):
    """Every (expert in use, row block holding a row in use, column block)
    is taken by exactly one block, no idle expert's tile by any (its
    weights are never read), each block's tiles in ascending order, and the
    blocks' shares differ by at most one tile where no row block is
    skipped."""
    rows = _rows(kind, E, C, seed=E + C + N + grid)
    bm = tqmm.expert_tile(C)
    walk = tqmm.expert_tiles(rows, C, N, bm, grid)
    assert len(walk) == grid
    taken = [t for block in walk for t in block]
    clamped = np.clip(rows, 0, C)
    want = {(e, m0, n0) for e in range(E) if clamped[e] > 0
            for m0 in range(0, int(clamped[e]), bm)
            for n0 in range(0, N, 128)}
    assert len(taken) == len(set(taken)) == len(want)
    assert set(taken) == want
    for block in walk:
        assert block == sorted(block)
    if all(-(-int(r) // bm) == -(-C // bm) for r in clamped if r > 0):
        sizes = [len(b) for b in walk]
        assert max(sizes) - min(sizes) <= 1


def test_tile_order_is_expert_major_round_robin():
    """Tile t goes to block t mod G, numbered over the experts in use in
    ascending order, then row blocks, then column blocks: consecutive
    blocks take one expert's column blocks side by side."""
    rows = np.array([0, 3, 0, 8, 1])
    walk = tqmm.expert_tiles(rows, 8, 384, 8, 4)
    order = [(1, 0, 0), (1, 0, 128), (1, 0, 256), (3, 0, 0), (3, 0, 128),
             (3, 0, 256), (4, 0, 0), (4, 0, 128), (4, 0, 256)]
    for t, tile in enumerate(order):
        assert walk[t % 4][t // 4] == tile
