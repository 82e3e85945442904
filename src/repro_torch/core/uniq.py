"""UNIQ orchestration: config, per-parameter transform, gradual schedule,
and the serving half (offline k-quantile coding into packed codes +
Gaussian statistics).

Three per-parameter modes (paper Sec. 3.3):

  CLEAN  (0) — parameter used as-is (blocks after the current stage).
  NOISE  (1) — uniform noise injection in the uniformized domain (the block
               currently being trained).
  FROZEN (2) — hard k-quantile quantization, zero gradient, optimizer-masked
               (blocks already processed).

A Gaussian k-quantile leaf goes through ``kernels/ops.py:uniq_transform``:
the ``uniq_noise`` CUDA kernels for CUDA tensors, their plain versions for
CPU tensors.  The noise is an input of the transform: ``leaf_noise`` draws
it per leaf from a generator keyed by (seed, step, md5 of the leaf path),
so a step's noise does not depend on launch order and a resumed run
replays it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import packing
from repro_torch.core.distributions import GaussianModel
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import CLEAN, FROZEN, NOISE

__all__ = ["CLEAN", "NOISE", "FROZEN", "UniqConfig", "transform_param",
           "transform_tree", "lm_mode_fn", "leaf_noise", "GradualSchedule",
           "fit_gaussian", "default_quant_filter", "path_str",
           "QuantizedTensor", "quantize_tensor"]


@dataclasses.dataclass(frozen=True)
class UniqConfig:
    """Quantization hyper-parameters (paper Sec. 4 defaults)."""

    w_bits: int = 4                 # weight bits  -> k = 2**w_bits levels
    a_bits: int = 8                 # activation bits (32 = off)
    method: str = "kquantile"       # kquantile (uniform | kmeans: not ported)
    dist: str = "gaussian"          # gaussian (empirical: serving only)
    per_channel: bool = False       # beyond-paper: per-out-channel (mu, sigma)
    quantize_embed: bool = True     # paper quantizes first & last layers
    n_stages: int = 0               # 0 => one stage per block group
    stage_iterations: int = 2       # paper: two passes over the blocks
    enabled: bool = True

    @property
    def k(self) -> int:
        return 2 ** self.w_bits


def _stats_axes(w: torch.Tensor, per_channel: bool, stacked: bool):
    """Axes whose statistics are kept separate.

    stacked (L, ...) parameters always get at least per-layer statistics
    (axis 0 preserved); per_channel additionally preserves the trailing
    (output) axis.  Non-stacked: per_channel preserves the trailing axis.
    """
    if stacked:
        if per_channel and w.ndim >= 3:
            return (0, w.ndim - 1)
        return (0,)
    if per_channel and w.ndim >= 2:
        return (w.ndim - 1,)
    return None


def fit_gaussian(w: torch.Tensor, axes_keep) -> GaussianModel:
    """GaussianModel with statistics reduced over all axes not in axes_keep."""
    if axes_keep is None:
        return GaussianModel.fit(w)
    reduce_axes = tuple(a for a in range(w.ndim) if a not in axes_keep)
    mu = torch.mean(w, dim=reduce_axes, keepdim=True)
    sigma = torch.clamp(
        torch.std(w, dim=reduce_axes, correction=0, keepdim=True), min=1e-8)
    return GaussianModel(mu=mu.detach(), sigma=sigma.detach())


def _fit_dist(w: torch.Tensor, cfg: UniqConfig, stacked: bool):
    """Distribution model for the kquantile path, honoring ``cfg.dist``.

    As in the reference, a non-Gaussian model applies to per-tensor
    statistics only; per-channel / stacked statistics stay Gaussian."""
    axes = _stats_axes(w, cfg.per_channel, stacked)
    if cfg.dist == "empirical" and axes is None:
        raise NotImplementedError(
            "dist='empirical' in training (the UNIQ transform through the "
            "EmpiricalModel) is not ported yet")
    if cfg.dist not in ("gaussian", "empirical"):
        raise ValueError(f"unknown distribution model: {cfg.dist!r}")
    return fit_gaussian(w, axes)


def _broadcast_mode(mode, w: torch.Tensor, stacked: bool) -> torch.Tensor:
    mode = torch.as_tensor(mode)
    if stacked and mode.ndim == 1:
        return mode.reshape((mode.shape[0],) + (1,) * (w.ndim - 1))
    return mode


def transform_param(w: torch.Tensor, e01: torch.Tensor, mode,
                    cfg: UniqConfig, stacked: bool = False,
                    use_kernel: bool = True) -> torch.Tensor:
    """Apply the 3-way UNIQ transform to one parameter.

    ``mode`` is one value for a plain parameter, or (L,) per layer for a
    stacked one; ``e01`` is w's shape of f32 U[0, 1) noise (read only by
    NOISE groups).  Differentiable in ``w`` through the fused kernel's
    backward.  ``use_kernel=False`` forces the plain versions (the
    comparison hook).
    """
    if not cfg.enabled or cfg.w_bits >= 32:
        return w
    if cfg.method != "kquantile":
        raise NotImplementedError(
            f"method={cfg.method!r} (the paper's uniform / k-means ablation "
            f"quantizers) is not ported yet; use method='kquantile'")
    model = _fit_dist(w, cfg, stacked)
    wg, ungroup = kops._grouped(w)
    eg, _ = kops._grouped(e01)
    mode_g = _broadcast_mode(mode, w, stacked).reshape(-1)
    out = kops.uniq_transform(wg, kops.grouped_stats(model.mu, w),
                              kops.grouped_stats(model.sigma, w), mode_g, eg,
                              k=cfg.k, use_kernel=use_kernel)
    return ungroup(out)


def default_quant_filter(path: str, leaf: torch.Tensor) -> bool:
    """Which parameters get quantized: matmul-weight-like tensors."""
    lower = path.lower()
    if leaf.ndim < 2:
        return False
    if lower.split("/")[-1] == "d":
        return False
    for token in ("norm", "router", "a_log", "dt_", "conv", "scale", "bias"):
        if token in lower:
            return False
    return True


def path_str(keys) -> str:
    """'/'-joined path of a leaf in a nested-dict parameter tree."""
    return "/".join(str(k) for k in keys)


_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from ``key`` and an integer (splitmix64 finaliser
    over their combination): the port's counterpart of
    ``jax.random.fold_in``, used to key generators by (seed, step, leaf)."""
    x = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def _fold_path(key: int, path: str) -> int:
    h = int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")
    return fold_in(key, h)


NoiseFn = Callable[[str, torch.Tensor], torch.Tensor]


def leaf_noise(seed: int, step: int) -> NoiseFn:
    """The training step's noise source: ``draw(path, leaf)`` is leaf's
    shape of f32 U[0, 1) on leaf's device, from a generator keyed by
    (seed, step, md5 of path).  The same key gives the same bits, whatever
    order the leaves are drawn in."""
    key = fold_in(seed, step)

    def draw(path: str, leaf: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=leaf.device)
        gen.manual_seed(_fold_path(key, path))
        return torch.rand(leaf.shape, generator=gen, device=leaf.device,
                          dtype=torch.float32)
    return draw


def lm_mode_fn(layer_modes: torch.Tensor):
    """Mode resolver for LM parameter trees with stacked layers: leaves
    under ``layers`` get the (L,) vector; the embedding belongs to the first
    gradual block and the LM head to the last (the paper quantizes first and
    last layers too)."""
    def mode_for(path: str):
        if path.startswith("layers"):
            return layer_modes
        if "embed" in path:
            return layer_modes[0]
        return layer_modes[-1]
    return mode_for


def transform_tree(params: Any, noise: NoiseFn, modes: Any,
                   cfg: UniqConfig,
                   quant_filter: Optional[Callable] = None,
                   stacked_prefixes: tuple = ("layers",),
                   use_kernel: bool = True) -> Any:
    """Apply UNIQ to a parameter tree (nested dicts of tensors).

    ``noise(path, leaf)`` gives each transformed leaf its U[0, 1) draw
    (``leaf_noise`` by default in the train step; a test may hand in the
    reference's own).  ``modes``: one mode for every quantized leaf, or a
    callable ``path -> mode`` (see ``lm_mode_fn``).  Leaves whose path
    starts with one of ``stacked_prefixes`` carry a leading layer axis and
    may receive an (L,) per-layer mode vector.
    """
    quant_filter = quant_filter or default_quant_filter
    mode_for = modes if callable(modes) else (lambda _p: modes)

    def one(p, leaf):
        if not quant_filter(p, leaf):
            return leaf
        if not cfg.quantize_embed and ("embed" in p or "head" in p):
            return leaf
        stacked = any(p.startswith(pre) for pre in stacked_prefixes)
        return transform_param(leaf, noise(p, leaf), mode_for(p), cfg,
                               stacked=stacked, use_kernel=use_kernel)

    return tree_lib.map_with_path(one, params)


# --------------------------------------------------------------------------
# Gradual quantization schedule (paper Sec. 3.3, App. B)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradualSchedule:
    """Maps training step -> per-layer modes.

    ``n_layers`` layers are grouped into ``n_blocks`` contiguous blocks; the
    budget of ``total_steps`` is split into ``n_blocks * iterations`` stages.
    At stage s (within an iteration): blocks < s are FROZEN, block s gets
    NOISE, blocks > s are CLEAN — except in iterations > 0 where every other
    block stays FROZEN and the active one is re-noised.  After all stages
    everything is FROZEN.  Modes are host values (CPU int32): the step is a
    host integer, so no device value is read to advance the schedule.
    """

    n_layers: int
    n_blocks: int
    total_steps: int
    iterations: int = 2

    def __post_init__(self):
        if self.n_layers < 1:
            raise ValueError(f"n_layers must be >= 1, got {self.n_layers}")
        if self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {self.n_blocks}")
        # n_blocks > n_layers would leave blocks with no layer: their stages
        # run with zero NOISE layers and silently burn step budget.
        if self.n_blocks > self.n_layers:
            object.__setattr__(self, "n_blocks", self.n_layers)

    @property
    def n_stages(self) -> int:
        return self.n_blocks * self.iterations

    @property
    def steps_per_stage(self) -> int:
        return max(1, self.total_steps // max(self.n_stages, 1))

    def block_of_layer(self) -> torch.Tensor:
        idx = torch.arange(self.n_layers)
        return (idx * self.n_blocks) // max(self.n_layers, 1)

    def modes_at(self, step) -> torch.Tensor:
        """(n_layers,) int32 modes for ``step`` (a host integer)."""
        stage = min(int(step) // self.steps_per_stage, self.n_stages)
        if stage >= self.n_stages:
            return torch.full((self.n_layers,), FROZEN, dtype=torch.int32)
        active_block = stage % self.n_blocks
        blocks = self.block_of_layer()
        frozen = (blocks < active_block) if stage // self.n_blocks == 0 \
            else (blocks != active_block)
        modes = torch.where(blocks == active_block, NOISE,
                            torch.where(frozen, FROZEN, CLEAN))
        return modes.to(torch.int32)

    def freeze_mask_at(self, step) -> torch.Tensor:
        """(n_layers,) bool — True where the optimizer may update."""
        return self.modes_at(step) != FROZEN


@dataclasses.dataclass
class QuantizedTensor:
    """Packed k-quantile codes + Gaussian statistics.

    codes: uint8 (int4 packed 2/byte along last axis) or int8 (8-bit).
    mu, sigma: broadcastable statistics (per-tensor or per-channel).
    """

    codes: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    bits: int
    shape: tuple

    @property
    def k(self) -> int:
        return 2 ** self.bits

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        codes = self.codes
        if self.bits == 4:
            codes = packing.unpack_int4(codes)
        c = codes.to(torch.float32) + (128.0 if self.k == 256 else 0.0)
        centers = torch.clamp((c + 0.5) / self.k, 1e-6, 1 - 1e-6)
        w = self.mu + self.sigma * torch.special.ndtri(centers)
        return w.reshape(self.shape).to(dtype)


def quantize_tensor(w: torch.Tensor, bits: int, per_channel: bool = True,
                    stacked: bool = False) -> QuantizedTensor:
    """Offline k-quantile quantization of a weight tensor for serving.

    Codes go through ``kernels/ops.py:quantize_weights`` (the
    ``kquantile_quantize`` kernel on CUDA tensors), whose CDF is the
    kernel's ``erf`` formulation: a code may differ from the reference's
    ``ndtr`` one where ``F(w) k`` sits within rounding of an integer
    (ROADMAP Queue 3)."""
    if bits not in (4, 8):
        raise ValueError(f"serving bits must be 4 or 8, got {bits}")
    model = fit_gaussian(w, _stats_axes(w, per_channel, stacked))
    stored = kops.quantize_weights(w, model.mu, model.sigma, bits=bits)
    return QuantizedTensor(stored, model.mu.to(torch.float32),
                           model.sigma.to(torch.float32), bits,
                           tuple(w.shape))
