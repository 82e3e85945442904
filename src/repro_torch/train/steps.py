"""Training step: UNIQ noise-injection QAT wired into the LM forward.

``make_train_step`` closes over static config and returns

    train_step(state, batch, seed, noise=None, scan_noise=None)
        -> (state, metrics)

where ``state = {"params", "opt", "step"}``.  The gradual schedule gives
per-layer modes from the step (a host integer); FROZEN layers are
hard-quantized with zero gradient in the forward AND masked in the
optimizer.  Every quantized leaf passes through the ``uniq_noise`` kernels
(``core/uniq.py:transform_tree``).  The step updates ``state`` in place
(see ``optim.apply_updates``) and returns it.

With ``TrainConfig.uniq_in_scan`` (dense, moe, vlm) the layers are
transformed one at a time inside the layer loop (``lm.forward_train``'s
``uniq_scan``) and only the embedding and the head at the tree level, as in
the reference: one layer's transformed copy is live at a time, recomputed
in the backward pass under remat.

With ``TrainConfig.dp_compress_bits`` on a mesh with a ``pod`` axis each
rank trains on its ``pod`` block of the batch and the gradients sync by the
int8 absmax codec (``make_loss_and_grads``); every rank applies the same
averaged gradients, so the parameters stay identical across ranks.

On a mesh the dense and vlm decoders train on placed state
(``place_state``: every parameter and moment the rank's block by
``param_shardings``, FSDP over "data" and tensor parallelism over "model";
``ModelOpts.placement`` names them): the batch is whole and each rank
takes its rows, the UNIQ statistics are the whole leaves' and each leaf's
noise the block of its whole draw, the gradients of the leaves a
data-parallel axis does not split are summed over it
(``tensor_parallel.sync_grads``), and the optimizer's norm and int8
moments read the whole leaves.  Inside a manual ``pod`` axis
(``dp_compress_bits``) the same holds on each pod's rows.

Noise: each leaf's U[0, 1) draw comes from a generator keyed by (seed,
step, md5 of the leaf path) on the parameters' device
(``core/uniq.py:leaf_noise``), in scan each layer slice's by (seed, step,
md5 of the weight's key, layer) (``layer_noise``), so it never depends on
launch order and a run resumed from a checkpoint replays the unbroken run
bit for bit.  ``noise`` / ``scan_noise`` override the draws (a test hands
in the reference's own).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core.uniq import (FROZEN, GradualSchedule, UniqConfig,
                                   default_quant_filter, layer_noise,
                                   leaf_noise, lm_mode_fn, transform_tree)
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.models.lm import ModelOpts
from repro_torch.optim import optim as optim_lib
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.collectives import make_pod_compressed_grads
from repro_torch.parallel.sharding import axis_sizes


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    uniq: UniqConfig = UniqConfig()
    optim: optim_lib.OptimConfig = optim_lib.OptimConfig()
    total_steps: int = 1000
    n_blocks: int = 0            # 0 -> one block per layer (paper App. B)
    lr_schedule: str = "stage"   # stage | cosine | constant
    dp_compress_bits: int = 0    # >0: int8-compress the cross-pod grad
                                 #   sync (parallel/collectives.py) on a
                                 #   mesh with a "pod" axis
    uniq_in_scan: bool = False   # transform per layer inside the layer
                                 #   loop (dense, moe, vlm): one layer's
                                 #   transformed copy live at a time

    @property
    def uniq_active(self) -> bool:
        return self.uniq.enabled and self.uniq.w_bits < 32


def make_schedule(cfg: ArchConfig, tc: TrainConfig) -> GradualSchedule:
    n_blocks = tc.n_blocks or cfg.n_layers
    return GradualSchedule(n_layers=cfg.n_layers, n_blocks=n_blocks,
                           total_steps=tc.total_steps,
                           iterations=tc.uniq.stage_iterations)


def make_lr_fn(tc: TrainConfig, schedule: GradualSchedule):
    if tc.lr_schedule == "cosine":
        return optim_lib.cosine_schedule(tc.optim.lr, tc.total_steps,
                                         warmup=tc.total_steps // 50)
    if tc.lr_schedule == "stage":
        return optim_lib.stage_scaled_lr(tc.optim.lr,
                                         schedule.steps_per_stage,
                                         decay=0.8)
    return optim_lib.constant_schedule(tc.optim.lr)


def freeze_mask_tree(params: Any, layer_modes: torch.Tensor,
                     quant_filter=None):
    """Per-leaf 0/1 trainability mask (f32, on each leaf's device) from
    per-layer modes.  Quantized + frozen leaves get 0 (per layer for stacked
    leaves); unquantized leaves (norms, biases) stay trainable throughout,
    as in the paper's fine-tuning protocol."""
    quant_filter = quant_filter or default_quant_filter
    mode_for = lm_mode_fn(layer_modes)

    def one(p, leaf):
        if not quant_filter(p, leaf):
            return torch.ones((), dtype=torch.float32, device=leaf.device)
        m = torch.as_tensor(mode_for(p))
        return (m != FROZEN).to(device=leaf.device, dtype=torch.float32)

    return tree_lib.map_with_path(one, params)


def in_scan(cfg: ArchConfig, tc: TrainConfig) -> bool:
    """Whether the step transforms the layers inside the layer loop: with
    ``uniq_in_scan`` at the decoder families, as the reference decides (the
    others take the whole-tree transform)."""
    return (tc.uniq_in_scan and tc.uniq_active
            and cfg.family in ("dense", "moe", "vlm"))


def _outside_layers(p: str, leaf) -> bool:
    return default_quant_filter(p, leaf) and not p.startswith("layers")


def loss_and_grads(params: Any, batch, modes: torch.Tensor, noise,
                   cfg: ArchConfig, opts: ModelOpts, tc: TrainConfig,
                   loss_fn: Optional[Callable] = None, scan_noise=None):
    """(loss, grads) of the loss at the UNIQ-transformed parameters, for
    per-layer ``modes`` (host int32), the per-leaf ``noise`` source and,
    in scan (``in_scan``), the per-layer ``scan_noise`` source (see
    ``core/uniq.py:layer_noise``): the embedding and the head are
    transformed here, the layers inside ``lm.forward_train``.
    ``opts.use_kernels=False`` takes the transform's plain versions."""
    base_loss = loss_fn or (lambda p, b: model.loss_fn(p, cfg, opts, b))
    scan = in_scan(cfg, tc)
    flat = list(tree_lib.leaves_with_paths(params))
    pl = opts.placement
    with torch.enable_grad():
        req = {p: t.detach().requires_grad_(True) for p, t in flat}
        p_in = tree_lib.map_with_path(lambda p, _t: req[p], params)
        if tc.uniq_active:
            dev = flat[0][1].device
            p_in = transform_tree(p_in, noise if pl is None
                                  else tpar.whole_noise(noise, pl),
                                  lm_mode_fn(modes.to(dev)), tc.uniq,
                                  quant_filter=_outside_layers if scan
                                  else None, use_kernel=opts.use_kernels,
                                  placement=pl)
        if scan:
            loss = model.loss_fn(p_in, cfg, opts, batch,
                                 uniq_scan=(tc.uniq, modes, scan_noise))
        else:
            loss = base_loss(p_in, batch)
        del p_in
        grads = torch.autograd.grad(loss, [req[p] for p, _ in flat],
                                    allow_unused=True)
    by_path = {p: (torch.zeros_like(t) if g is None else g)
               for (p, t), g in zip(flat, grads)}
    grads = tree_lib.map_with_path(lambda p, _t: by_path[p], params)
    if pl is not None:
        grads = tpar.sync_grads(grads, opts)
    return loss.detach(), grads


def _compressing(opts: ModelOpts, tc: TrainConfig):
    """(the options the loss and gradients run under, whether the pod sync
    compresses): with ``tc.dp_compress_bits`` on a mesh with a ``pod``
    axis, ``pod`` is manual (the caller's rows, the placement's sums taken
    without it)."""
    compress = bool(tc.dp_compress_bits) and opts.mesh is not None \
        and "pod" in axis_sizes(opts.mesh)
    if not compress:
        return opts, False
    inner = dataclasses.replace(opts, manual_axes=("pod",))
    if opts.placement is not None:
        inner = dataclasses.replace(inner, placement=dataclasses.replace(
            opts.placement, manual_axes=("pod",)))
    return inner, True


def make_loss_and_grads(cfg: ArchConfig, opts: ModelOpts, tc: TrainConfig,
                        loss_fn: Optional[Callable] = None):
    """``fn(params, batch, modes, noise, scan_noise) -> (loss, grads)``:
    ``loss_and_grads`` under ``opts``, and with ``tc.dp_compress_bits`` on
    a mesh with a ``pod`` axis (``opts.mesh``) each rank's ``pod`` block of
    the batch, the gradients synced by ``compressed_pmean`` over ``pod``
    and the loss by the exact mean (the inner options take
    ``manual_axes=("pod",)``).  A MoE config raises there, as the
    reference does."""
    inner_opts, compress = _compressing(opts, tc)
    if compress:
        if cfg.is_moe:
            raise NotImplementedError(
                "dp_compress + shard_map EP would nest manual regions; "
                "use GSPMD sync for MoE cells")

    def fn(params, batch, modes, noise, scan_noise):
        return loss_and_grads(params, batch, modes, noise, cfg, inner_opts,
                              tc, loss_fn, scan_noise)

    if compress:
        fn = make_pod_compressed_grads(fn, opts.mesh,
                                       bits=tc.dp_compress_bits,
                                       placement=inner_opts.placement)
    return fn


def make_train_step(cfg: ArchConfig, opts: ModelOpts, tc: TrainConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns (train_step, schedule)."""
    schedule = make_schedule(cfg, tc)
    lr_fn = make_lr_fn(tc, schedule)
    grads_fn = make_loss_and_grads(cfg, opts, tc, loss_fn)
    # after a compressed sync the gradients are the same on every pod
    placement = _compressing(opts, tc)[0].placement

    def train_step(state, batch, seed: int, noise=None, scan_noise=None):
        step = int(state["step"])
        modes = schedule.modes_at(step)
        noise = noise or leaf_noise(seed, step)
        scan_noise = scan_noise or layer_noise(seed, step)
        loss_val, grads = grads_fn(state["params"], batch, modes, noise,
                                   scan_noise)
        mask = (freeze_mask_tree(state["params"], modes)
                if tc.uniq_active else None)
        lr = lr_fn(step)
        _, _, om = optim_lib.apply_updates(state["params"], grads,
                                           state["opt"], tc.optim, lr,
                                           freeze_mask=mask,
                                           placement=placement)
        del grads
        state["step"] = state["step"] + 1
        return state, {"loss": loss_val, "lr": lr, **om}

    return train_step, schedule


def init_state(seed: int, cfg: ArchConfig, tc: TrainConfig, device="cuda",
               init_fn: Optional[Callable] = None):
    """Fresh {"params", "opt", "step"} on ``device`` (f32 parameters drawn
    from ``seed``; ``step`` and the optimizer's ``count`` are host
    values)."""
    dev = resolve_device(device)
    params = (init_fn or (lambda s: model.init(s, cfg, device=dev)))(seed)
    return {"params": params,
            "opt": optim_lib.init_state(params, tc.optim),
            "step": torch.zeros((), dtype=torch.int32)}


def place_state(state, cfg: ArchConfig, opts: ModelOpts, fsdp=True):
    """(this rank's blocks of a whole train state, ``opts`` naming them):
    the parameters by ``param_shardings(..., fsdp, tp=not
    opts.dp_includes_model)``, each moment as its parameter, ``count`` and
    ``step`` whole (``sharding.state_shardings``)."""
    pshard = shd.param_shardings(state["params"], cfg, opts.mesh, fsdp=fsdp,
                                 tp=not opts.dp_includes_model)
    placed = shd.place_tree(state, shd.state_shardings(state, pshard,
                                                       opts.mesh))
    return placed, dataclasses.replace(
        opts, placement=shd.Placement.of(pshard, opts.manual_axes))


def eval_step(cfg: ArchConfig, opts: ModelOpts):
    """Deterministic-quantized eval (the inference-time model): every
    quantized weight hard-quantized (FROZEN) with the k-quantile quantizer,
    per the paper."""
    @torch.no_grad()
    def step(params, batch, w_bits: int):
        if w_bits < 32:
            pl = opts.placement
            noise = leaf_noise(0, 0) if pl is None \
                else tpar.whole_noise(leaf_noise(0, 0), pl)
            params = transform_tree(params, noise, FROZEN,
                                    UniqConfig(w_bits=w_bits),
                                    use_kernel=opts.use_kernels,
                                    placement=pl)
        return model.loss_fn(params, cfg, opts, batch)
    return step
