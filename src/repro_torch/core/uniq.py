"""UNIQ orchestration: config, per-parameter transform, gradual schedule,
and the serving half (offline k-quantile coding into packed codes +
Gaussian statistics).

Three per-parameter modes (paper Sec. 3.3):

  CLEAN  (0) — parameter used as-is (blocks after the current stage).
  NOISE  (1) — uniform noise injection in the uniformized domain (the block
               currently being trained).
  FROZEN (2) — hard k-quantile quantization, zero gradient, optimizer-masked
               (blocks already processed).

A Gaussian k-quantile leaf goes through ``kernels/ops.py:uniq_transform``
(or ``uniq_transform_onchip``): the ``uniq_noise`` CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.  Each leaf's noise is keyed
by (seed, step, md5 of the leaf path) (``leaf_key``), so a step's noise
does not depend on launch order and a resumed run replays it.  Two noise
sources give a leaf its noise:

  * ``leaf_noise(seed, step)``, a ``NoiseFn``: a (leaf-shaped) U[0, 1)
    tensor drawn by a ``torch.Generator`` seeded with the key, read by the
    kernel as an operand (the LM trainer; a test hands in the reference's
    own draw through a ``NoiseFn``); ``layer_noise(seed, step)`` draws
    one layer slice's noise under a (seed, step, weight, layer) key for the
    transform inside the layer loop (``lm.forward_train``'s ``uniq_scan``);
  * ``onchip_noise(seed, step)``, a ``NoiseFn`` too: the leaf's int key
    itself, from which the forward kernel draws inside (Philox4x32-10; the
    CNN trainer).  Its plain version draws the same bits, so the card and
    the CPU see the same noise.

The uniform / k-means ablation quantizers (paper Table 3) are plain torch
ops (``core/noise.py``), as they are jnp in the reference; so is the
k-quantile transform of a leaf under ``dist="empirical"`` (per-tensor,
unstacked leaves only: ``_fit_dist``), whose CDF is a ``searchsorted`` and
so passes no gradient to its weight in NOISE, as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Union

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import noise as noise_lib
from repro_torch.core import packing
from repro_torch.core import quantizers as Q
from repro_torch.core.distributions import EmpiricalModel, GaussianModel
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import CLEAN, FROZEN, NOISE

__all__ = ["CLEAN", "NOISE", "FROZEN", "UniqConfig", "transform_param",
           "transform_tree", "lm_mode_fn", "leaf_noise", "onchip_noise",
           "leaf_key", "layer_noise", "GradualSchedule",
           "fit_gaussian", "fit_layers", "default_quant_filter", "path_str",
           "QuantizedTensor", "quantize_tensor", "quantize_tree"]


@dataclasses.dataclass(frozen=True)
class UniqConfig:
    """Quantization hyper-parameters (paper Sec. 4 defaults)."""

    w_bits: int = 4                 # weight bits  -> k = 2**w_bits levels
    a_bits: int = 8                 # activation bits (32 = off)
    method: str = "kquantile"       # kquantile | uniform | kmeans
    dist: str = "gaussian"          # gaussian | empirical (per-tensor leaves)
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
    statistics only (the sorted-sample ECDF has no per-channel form);
    per-channel / stacked statistics stay Gaussian."""
    axes = _stats_axes(w, cfg.per_channel, stacked)
    if cfg.dist == "empirical" and axes is None:
        return EmpiricalModel.fit(w)
    if cfg.dist not in ("gaussian", "empirical"):
        raise ValueError(f"unknown distribution model: {cfg.dist!r}")
    return fit_gaussian(w, axes)


def fit_layers(w: torch.Tensor, cfg: UniqConfig, placement=None,
               path: str = "") -> GaussianModel:
    """The per-layer statistics of a stacked (L, ...) leaf as the
    whole-tree transform fits them.  The transform inside the layer loop
    (``lm.forward_train``'s ``uniq_scan``) hands layer l's slice of them to
    ``transform_param``, so both paths see the same values to the bit and
    the stack is reduced once a step, not a slice at a time.  With
    ``placement`` w is a rank's block of the leaf at ``path``
    (``fit_placed``)."""
    if placement is not None:
        return fit_placed(w, cfg, True, path, placement)
    return _fit_dist(w, cfg, stacked=True)


@torch.no_grad()
def fit_placed(w: torch.Tensor, cfg: UniqConfig, stacked: bool, path: str,
               placement):
    """The whole leaf's distribution model from a rank's block ``w`` of the
    leaf at ``path`` of a placed tree (``sharding.Placement``): the
    reduced dims' sum all-reduced over the axes they are split on, the
    mean, then the centred sum of squares all-reduced, the standard
    deviation (the two passes of ``torch.mean`` / ``torch.std``, in another
    order of summation); the statistics of the dims kept are the block's
    own.  Where no reduced dim is split over more than one rank the block
    holds them whole, and they are fitted as without a mesh, to the bit (a
    NOISE weight's gradient moves far with its statistics' last bit, where
    its draw lands near the clamp).  An empirical model needs the whole
    sorted sample: the leaf is all-gathered."""
    axes = _stats_axes(w, cfg.per_channel, stacked)
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import axis_sizes
    red = tuple(a for a in range(w.ndim) if axes is None or a not in axes)
    sizes = axis_sizes(placement.mesh)
    split = tuple(a for a in placement.split_axes(path, red)
                  if sizes[a] > 1)
    if not split:
        return _fit_dist(w, cfg, stacked)
    if cfg.dist == "empirical" and axes is None:
        return EmpiricalModel.fit(placement.sharding(path).whole(w))
    if cfg.dist not in ("gaussian", "empirical"):
        raise ValueError(f"unknown distribution model: {cfg.dist!r}")
    whole = placement.whole_shape(path, w.shape)
    n = 1
    for a in red:
        n *= whole[a]
    groups = placement.groups(split)
    s = coll.all_reduce(torch.sum(w, dim=red, keepdim=True), groups)
    mu = s / n
    c = coll.all_reduce(torch.sum(torch.square(w - mu), dim=red,
                                  keepdim=True), groups)
    return GaussianModel(mu=mu, sigma=torch.clamp(torch.sqrt(c / n),
                                                  min=1e-8))


def _broadcast_mode(mode, w: torch.Tensor, stacked: bool) -> torch.Tensor:
    mode = torch.as_tensor(mode)
    if stacked and mode.ndim == 1:
        return mode.reshape((mode.shape[0],) + (1,) * (w.ndim - 1))
    return mode


def _ablation(w: torch.Tensor, e01: torch.Tensor, mode, cfg: UniqConfig,
              stacked: bool) -> torch.Tensor:
    """The uniform / k-means branch (the reference's ``uniq.py:110-116``):
    per-bin noise for NOISE, the deterministic quantizer (no gradient) for
    FROZEN, ``w`` for CLEAN; per-tensor statistics."""
    noisy = noise_lib.ABLATION_INJECT[cfg.method](w, e01, cfg.k)
    frozen = Q.fakequant(w.detach(), cfg.k, method=cfg.method)
    m = _broadcast_mode(mode, w, stacked).to(w.device)
    return torch.where(m == CLEAN, w, torch.where(m == NOISE, noisy, frozen))


def transform_param(w: torch.Tensor, noise: Union[torch.Tensor, int], mode,
                    cfg: UniqConfig, stacked: bool = False,
                    use_kernel: bool = True,
                    model: Optional[GaussianModel] = None) -> torch.Tensor:
    """Apply the 3-way UNIQ transform to one parameter.

    ``mode`` is one value for a plain parameter, or (L,) per layer for a
    stacked one.  ``noise`` is either w's shape of f32 U[0, 1) noise (read
    only by NOISE groups), or the leaf's int key, from which the k-quantile
    forward kernel draws on chip (``kernels/ops.py:uniq_transform_onchip``)
    and the ablation quantizers draw through ``keyed_uniform``.
    Differentiable in ``w``: through the fused kernel's backward
    (k-quantile), through torch autograd (ablation).  ``use_kernel=False``
    forces the kernels' plain versions (the comparison hook).  ``model``
    gives w's statistics where they were fitted beforehand (a layer's slice
    of ``fit_layers``); else they are fitted here.
    """
    if not cfg.enabled or cfg.w_bits >= 32:
        return w
    onchip = isinstance(noise, int)
    if cfg.method != "kquantile":
        if cfg.method not in noise_lib.ABLATION_INJECT:
            raise ValueError(f"unknown quantizer: {cfg.method!r}")
        e01 = keyed_uniform(noise, w) if onchip else noise
        return _ablation(w, e01, mode, cfg, stacked)
    if model is None:
        model = _fit_dist(w, cfg, stacked)
    if isinstance(model, EmpiricalModel):
        e01 = keyed_uniform(noise, w) if onchip else noise
        return _transform_empirical(w, e01, mode, cfg, model, stacked)
    wg, ungroup = kops._grouped(w)
    mode_g = _broadcast_mode(mode, w, stacked).reshape(-1)
    mu = kops.grouped_stats(model.mu, w)
    sigma = kops.grouped_stats(model.sigma, w)
    if onchip:
        out = kops.uniq_transform_onchip(wg, mu, sigma, mode_g, noise,
                                         k=cfg.k, use_kernel=use_kernel)
    else:
        out = kops.uniq_transform(wg, mu, sigma, mode_g,
                                  kops._grouped(noise)[0], k=cfg.k,
                                  use_kernel=use_kernel)
    return ungroup(out)


def _transform_empirical(w: torch.Tensor, e01: torch.Tensor, mode,
                         cfg: UniqConfig, model: EmpiricalModel,
                         stacked: bool) -> torch.Tensor:
    """The k-quantile transform through an empirical CDF (the reference's
    ``uniq.py:119-130``), plain torch as the reference's jnp: no kernel
    takes a sorted sample.  ``u = cdf(w)`` is a ``searchsorted`` and the
    sample is detached, so NOISE passes no gradient to ``w``; FROZEN none
    either (bin centres); CLEAN gives ``w``."""
    k = cfg.k
    u = model.cdf(w)
    u_noise = torch.clamp(u + (e01.to(u.device) - 0.5) * (1.0 / k),
                          1e-6, 1.0 - 1e-6)
    codes = torch.clamp(torch.floor(u * k), 0, k - 1)
    m = _broadcast_mode(mode, w, stacked).to(w.device)
    u_sel = torch.where(m == NOISE, u_noise, (codes + 0.5) / k)
    w_hat = model.quantile(u_sel).to(w.dtype)
    w_hat = torch.where(m == FROZEN, w_hat.detach(), w_hat)
    return torch.where(m == CLEAN, w, w_hat)


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


# (path, leaf) -> the leaf's U[0, 1) draw, or its int key for the on-chip draw
NoiseFn = Callable[[str, torch.Tensor], Union[torch.Tensor, int]]


def leaf_key(seed: int, step: int, path: str) -> int:
    """The 63-bit key of one leaf's noise at one step."""
    return _fold_path(fold_in(seed, step), path)


def keyed_uniform(key: int, leaf: torch.Tensor) -> torch.Tensor:
    """leaf's shape of f32 U[0, 1) on leaf's device, from a
    ``torch.Generator`` seeded with ``key``."""
    gen = torch.Generator(device=leaf.device)
    gen.manual_seed(int(key))
    return torch.rand(leaf.shape, generator=gen, device=leaf.device,
                      dtype=torch.float32)


def leaf_noise(seed: int, step: int) -> NoiseFn:
    """The host-draw noise source: ``draw(path, leaf)`` is
    ``keyed_uniform(leaf_key(seed, step, path), leaf)``.  The same key
    gives the same bits, whatever order the leaves are drawn in."""
    def draw(path: str, leaf: torch.Tensor) -> torch.Tensor:
        return keyed_uniform(leaf_key(seed, step, path), leaf)
    return draw


def onchip_noise(seed: int, step: int) -> NoiseFn:
    """The on-chip noise source: ``key(path, leaf)`` is
    ``leaf_key(seed, step, path)``, from which the transform draws inside
    the kernel."""
    def key(path: str, _leaf: torch.Tensor) -> int:
        return leaf_key(seed, step, path)
    return key


# (key, layer, leaf) -> one layer's U[0, 1) draw of one of its weights
LayerNoiseFn = Callable[[str, int, torch.Tensor], torch.Tensor]


def layer_noise(seed: int, step: int) -> LayerNoiseFn:
    """The per-layer noise source of ``uniq_scan``: ``draw(key, layer,
    leaf)`` draws one layer slice's shape of a layer's weight ``key``
    ("wq", "eg", ...) under the reference's ``fold_in(_fold_path(rng, key),
    layer)`` (``rng`` the step's key, as in ``leaf_key``): the same bits
    however often the layer is recomputed."""
    def draw(key: str, layer: int, leaf: torch.Tensor) -> torch.Tensor:
        return keyed_uniform(
            fold_in(_fold_path(fold_in(seed, step), key), layer), leaf)
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


def transform_tree(params: Any, noise: NoiseFn, modes: Any, cfg: UniqConfig,
                   quant_filter: Optional[Callable] = None,
                   stacked_prefixes: tuple = ("layers",),
                   use_kernel: bool = True, placement=None) -> Any:
    """Apply UNIQ to a parameter tree (nested dicts of tensors).

    ``noise(path, leaf)`` gives each transformed leaf its U[0, 1) draw
    (``leaf_noise`` in the LM train step; a test may hand in the
    reference's own) or its int key for the on-chip draw
    (``onchip_noise``).  ``modes``: one mode for every quantized leaf, or a
    callable ``path -> mode`` (see ``lm_mode_fn``).  Leaves whose path
    starts with one of ``stacked_prefixes`` carry a leading layer axis and
    may receive an (L,) per-layer mode vector.  With ``placement``
    (``sharding.Placement``) the leaves are a rank's blocks: each takes the
    whole leaf's statistics (``fit_placed``), and ``noise`` must give the
    block of the whole leaf's draw; the ablation quantizers are not placed
    (they raise).
    """
    quant_filter = quant_filter or default_quant_filter
    mode_for = modes if callable(modes) else (lambda _p: modes)

    def one(p, leaf):
        if not quant_filter(p, leaf):
            return leaf
        if not cfg.quantize_embed and ("embed" in p or "head" in p):
            return leaf
        stacked = any(p.startswith(pre) for pre in stacked_prefixes)
        model = None
        if placement is not None:
            if cfg.method != "kquantile":
                raise NotImplementedError(
                    f"the {cfg.method} quantizer on placed leaves: its "
                    f"statistics are the block's (only kquantile is "
                    f"placed)")
            model = fit_placed(leaf, cfg, stacked, p, placement)
        return transform_param(leaf, noise(p, leaf), mode_for(p), cfg,
                               stacked=stacked, use_kernel=use_kernel,
                               model=model)

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


def quantize_tree(params: Any, bits: int,
                  quant_filter: Optional[Callable[[str, torch.Tensor],
                                                  bool]] = None,
                  per_channel: bool = True,
                  stacked_prefixes: tuple = ("layers",)) -> Any:
    """Quantize every eligible leaf of a parameter tree for serving: a
    ``QuantizedTensor`` where ``quant_filter(path, leaf)`` holds (leaves
    under ``stacked_prefixes`` with per-layer statistics), the leaf itself
    elsewhere."""
    quant_filter = quant_filter or default_quant_filter

    def one(p, leaf):
        if not quant_filter(p, leaf):
            return leaf
        stacked = any(p.startswith(pre) for pre in stacked_prefixes)
        return quantize_tensor(leaf, bits, per_channel=per_channel,
                               stacked=stacked)

    return tree_lib.map_with_path(one, params)
