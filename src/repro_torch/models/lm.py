"""Decoder-only LM (the dense, MoE and vlm families): the training forward
(``forward_train`` + ``chunked_ce_loss``: dense and vlm) and the serving
path (prefill, chunked prefill, decode).  The vlm family (pixtral) is the
dense decoder with precomputed patch embeddings ahead of the tokens (at
prefill and in training).

Every per-layer parameter carries a leading (L,) axis and the forward pass
is a Python loop over ``leaf[l]`` views.  Serving-time weights may be
k-quantile-coded: a weight leaf replaced by a ``{"q_codes", "q_mu",
"q_sigma"}`` dict (Gaussian levels) or a ``{"q_codes", "q_lut"}`` dict (an
empirical codebook; see ``quantize_params_for_serving``) is multiplied
through the dequant-fused ``qmatmul`` / ``qmatmul_lut`` kernel on the card
(its plain version on the CPU), and with ``serve_a_bits < 32`` through the
int8-activation ``qmatmul_a8``.  An MoE layer's expert stacks ``eg`` / ``eu``
/ ``ed`` go through ``models/moe.py`` (one ``qmatmul_experts`` launch per
matrix; its f32 router is never coded).  ``a_bits < 32`` fake-quantizes each
layer's output (``_maybe_quant_act``).  The KV cache — the slot layout of
``init_cache`` or the paged pool of ``init_paged_cache`` — is updated in
place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core import activations as act
from repro_torch.core import packing
from repro_torch.core import quantizers as Q
from repro_torch.core.distributions import EmpiricalModel, GaussianModel
from repro_torch.core.uniq import (default_quant_filter, fit_layers,
                                   path_str, quantize_tensor,
                                   transform_param)
from repro_torch.devices import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import kv_cache as kvq
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       layer_norm, rms_norm, rope_cos_sin,
                                       softcap)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tpar

BIG_WINDOW = 1 << 30
# the empirical coding holds an int64 rank and an f32 value for each element
# it codes (``EmpiricalModel.cdf``): a leaf slice is coded in blocks of its
# leading axis of at most this many elements (at least one row), so an
# expert stack's layer slice at full width (5.6 G elements at kimi_k2, 5.4 G
# at llama4: 67 GB of ranks and values whole) holds a block's worth
EMPIRICAL_BLOCK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    """Runtime (non-architecture) options of the serving path."""
    compute_dtype: Any = torch.bfloat16
    a_bits: int = 32                  # activation fake-quant (32 = off)
    serve_a_bits: int = 32            # serving activation codec on quantized
                                      #   matmuls: 2..8 => per-token int8
                                      #   codes + absmax scale before the dot
                                      #   (the qmatmul_a8 kernel; threaded
                                      #   from EngineConfig.a_bits); 32 = off
    kv_bits: int = 16                 # 8/4 => k-quantile-coded KV cache
    remat: bool = True                # training: recompute each layer in the
                                      #   backward (torch.utils.checkpoint)
    kv_chunk: int = 1024              # chunked-attention KV block
    attn_chunked_min_len: int = 8192  # chunked attention from this S on
    ssd_chunk: int = 128              # SSD scan chunk (ssm / hybrid prefill)
    ce_chunk: int = 1024              # cross-entropy chunk along S
    use_kernels: bool = True          # comparison hook: False computes every
                                      #   kernel's plain PyTorch version on
                                      #   whatever device the tensors are on
    moe_axis: Optional[str] = None    # 'model' => expert-parallel MoE over
                                      #   the mesh (_moe_ep_sharded)
    mesh: Any = None                  # DeviceMesh (launch/mesh.py) of the
                                      #   expert-parallel region
    fsdp_axes: tuple = ("data",)      # axes expert weights are FSDP-sharded on
    manual_axes: tuple = ()           # mesh axes the caller already splits
                                      #   (the compressed sync's "pod")
    moe_mode: str = "gather"          # gather: each rank its experts' whole
                                      #   weights, the tokens split over the
                                      #   DP axes; reduce: d_ff split over
                                      #   fsdp_axes, the partial outputs summed
    dp_includes_model: bool = False   # fsdp-only layout: batch over
                                      #   (pod, data, model); "tp" dims of
                                      #   shard_act stay whole
    placement: Any = None             # sharding.Placement of the placed
                                      #   parameters (tensor_parallel.
                                      #   place_params): the dense / vlm
                                      #   decoder runs on the mesh's blocks


# --------------------------------------------------------------------------
# Activation layouts
# --------------------------------------------------------------------------

def shard_act(shape, opts: ModelOpts, *axes) -> shd.PartitionSpec:
    """The layout of an activation of (whole) ``shape``: one entry per dim
    from the sentinels "dp" (the data-parallel axes that are not manual,
    "model" too with ``dp_includes_model``, the innermost dropped until
    the dim divides), "tp" ("model" where the dim divides it and
    ``dp_includes_model`` is off) or None.  The reference constrains the
    activation to it; the placed layers read it: the rows of the batch a
    rank takes ("dp") and whether a rank's heads are its own ("tp").
    Everything whole without a mesh."""
    mesh = opts.mesh
    if mesh is None:
        return shd.P(*(None,) * len(axes))
    sizes = shd.axis_sizes(mesh)
    dp_names = ("pod", "data", "model") if opts.dp_includes_model \
        else ("pod", "data")
    out = []
    for i, a in enumerate(axes):
        if a == "dp":
            dp = [x for x in dp_names if x in sizes
                  and x not in opts.manual_axes]
            while dp and shape[i] % math.prod(sizes[x] for x in dp):
                dp.pop()
            out.append(tuple(dp) or None)
        elif a == "tp":
            ok = ("model" in sizes and not opts.dp_includes_model
                  and shape[i] % sizes["model"] == 0)
            out.append("model" if ok else None)
        else:
            out.append(None)
    return shd.P(*out)


def _placed(opts: ModelOpts) -> bool:
    return opts.placement is not None


# --------------------------------------------------------------------------
# Quantized-weight matmul dispatch
# --------------------------------------------------------------------------

def is_qweight(w) -> bool:
    return isinstance(w, dict) and "q_codes" in w


def _bits_of(codes: torch.Tensor) -> int:
    return 4 if codes.dtype == torch.uint8 else 8


def _lut_levels(codes: torch.Tensor, lut: torch.Tensor,
                bits: int) -> torch.Tensor:
    """Codebook dequant (``dist="empirical"``): a per-code gather from a
    per-tensor (k,) codebook, or from stacked per-layer (L, k) codebooks
    against codes (L, ...), as the reference's ``materialize`` does."""
    if bits == 4:
        codes = packing.unpack_int4(codes)
    idx = codes.to(torch.int64)
    if bits == 8:
        idx = idx + 128                     # undo the int8 storage offset
    if lut.ndim == 1:
        return lut[idx]
    flat = torch.gather(lut, 1, idx.reshape(idx.shape[0], -1))
    return flat.reshape(idx.shape)


def materialize(w, dtype, use_kernels: bool = True) -> torch.Tensor:
    """Return a dense (possibly dequantized) weight in ``dtype``.

    Gaussian codes go through ``kquantile_dequantize`` (the kernel for CUDA
    tensors; ``use_kernels=False`` is the comparison hook), codebook codes
    through a gather."""
    if not is_qweight(w):
        return w.to(dtype)
    codes = w["q_codes"]
    bits = _bits_of(codes)
    if "q_lut" in w:
        return _lut_levels(codes, w["q_lut"], bits).to(dtype)
    out = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    return kops.dequantize_weights(codes, w["q_mu"], w["q_sigma"],
                                   bits=bits, out_dtype=out,
                                   use_kernel=use_kernels).to(dtype)


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) of one low-precision dtype, accumulated into
    and returned as f32 (``jnp.dot(..., preferred_element_type=f32)``).
    The products of two bf16 values are exact in f32, so widening first is
    the same function; on the card ``aten::mm.dtype`` does it without the
    widened copies."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cuda":
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.to(torch.float32) @ w.to(torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def mm(x: torch.Tensor, w, use_kernels: bool = True,
       out_dtype=None) -> torch.Tensor:
    """x @ w where w is a dense tensor or a quantized-weight dict.

    A Gaussian-coded 2-D weight goes through ``qmatmul``, a codebook-coded
    one through ``qmatmul_lut`` (the CUDA kernels for CUDA tensors); a
    dense weight through ``torch.matmul``, its value rounded to x's dtype
    first.  A low-precision x with an f32 ``out_dtype`` (the LM head)
    accumulates into f32 logits.
    """
    out_dtype = out_dtype or x.dtype
    if is_qweight(w) and w["q_codes"].ndim == 2:
        bits = _bits_of(w["q_codes"])
        if "q_lut" in w:
            return kops.qmatmul_lut(x, w["q_codes"], w["q_lut"], bits=bits,
                                    out_dtype=out_dtype,
                                    use_kernel=use_kernels)
        return kops.qmatmul(x, w["q_codes"], w["q_mu"], w["q_sigma"],
                            bits=bits, out_dtype=out_dtype,
                            use_kernel=use_kernels)
    w = materialize(w, x.dtype, use_kernels)
    if out_dtype == torch.float32 and x.dtype != torch.float32:
        return _dot_f32(x, w)
    return torch.matmul(x, w).to(out_dtype)


def mm_a(x: torch.Tensor, w, opts: ModelOpts, scale_groups=None,
         out_dtype=None) -> torch.Tensor:
    """``mm`` with the serving activation codec (the A8 path).

    With ``opts.serve_a_bits < 32`` and a quantized weight, the activation
    is coded per token (absmax scale over the feature axis,
    ``core/activations.py``) and the f32 ``code * scale`` is multiplied by
    f32 levels, the result cast to x's dtype: the reference's ``mm_a``.
    Gaussian weights go through ``qmatmul_a8``, codebook weights through
    ``qmatmul_lut`` on the f32 activation.  Dense weights and
    ``serve_a_bits >= 32`` fall through to ``mm``.  ``scale_groups``: x
    is a rank's block of columns (a row-parallel product), its per-token
    scale the whole row's (a max all-reduce over those groups).
    ``out_dtype`` (default x's): the result's dtype.
    """
    bits = opts.serve_a_bits
    out_dtype = out_dtype or x.dtype
    if bits >= 32 or not is_qweight(w):
        return mm(x, w, opts.use_kernels, out_dtype=out_dtype)
    scale = act.act_scale(x, bits, axis=-1)
    if scale_groups:
        scale = coll.all_reduce_max(scale, scale_groups)
    codes, scale = act.quant_act(x, bits, scale)
    wbits = _bits_of(w["q_codes"])
    if w["q_codes"].ndim == 2 and "q_lut" not in w:
        return kops.qmatmul_a8(codes, scale, w["q_codes"], w["q_mu"],
                               w["q_sigma"], bits=wbits, out_dtype=out_dtype,
                               use_kernel=opts.use_kernels)
    a = codes.to(torch.float32) * scale
    if w["q_codes"].ndim == 2:
        return kops.qmatmul_lut(a, w["q_codes"], w["q_lut"], bits=wbits,
                                out_dtype=out_dtype,
                                use_kernel=opts.use_kernels)
    return torch.matmul(a, materialize(w, torch.float32,
                                       opts.use_kernels)).to(out_dtype)


# --------------------------------------------------------------------------
# Parameter trees: nested dicts of tensors
# --------------------------------------------------------------------------

_STACKED_PREFIXES = ("layers", "enc_layers", "dec_layers")


def _walk(tree, prefix=()):
    """Yield (keys, leaf) for every tensor leaf, treating a quantized-weight
    dict as one leaf."""
    for key, val in tree.items():
        if isinstance(val, dict) and not is_qweight(val):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _set(tree, keys, val):
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = val


def _quantize_leaf_empirical(leaf: torch.Tensor, bits: int, stacked: bool):
    """Code one leaf against its per-tensor empirical quantiles, with the
    k-level codebook beside the codes (``{"q_codes", "q_lut"}``, the
    paper's "look-up table availability" case).  A stacked leaf gets one
    codebook per layer, (L, k); the layer loop slices it to (k,) with the
    codes.  Codes keep the weight path's storage conventions (int4
    packing, int8 k = 256 offset), so ``qmatmul_lut`` takes them as they
    are.

    The codebook is fitted on the whole slice's strided subsample
    (``EmpiricalModel.fit``); the slice is then coded a block of its
    leading axis at a time (``EMPIRICAL_BLOCK_ELEMS``: an expert stack's
    experts, a matrix's rows) into the preallocated codes.  The CDF is
    elementwise, so the codes equal coding the slice whole, bit for bit."""
    k = 2 ** bits

    def one(w):
        m = EmpiricalModel.fit(w)
        stored = torch.empty(packing.packed_shape(tuple(w.shape), bits),
                             dtype=packing.storage_dtype(bits),
                             device=w.device)
        rows = max(1, EMPIRICAL_BLOCK_ELEMS // max(1, w[0].numel()))
        for i in range(0, w.shape[0], rows):
            codes = Q.kquantile_quantize(w[i:i + rows], m, k)
            stored[i:i + rows] = packing.pack_int4(codes) if bits == 4 \
                else (codes - 128).to(torch.int8)
            del codes
        return stored, m.level_values(k).to(torch.float32)

    if not stacked:
        stored, lut = one(leaf)
        return {"q_codes": stored, "q_lut": lut}
    parts = [one(leaf[l]) for l in range(leaf.shape[0])]
    return {"q_codes": torch.stack([p[0] for p in parts]),
            "q_lut": torch.stack([p[1] for p in parts])}


def _quantize_leaf(leaf: torch.Tensor, bits: int, per_channel: bool,
                   stacked: bool, dist: str = "gaussian"):
    """Code one leaf.  A stacked leaf is coded one layer at a time: its
    statistics are per layer anyway, and the temporaries stay one layer
    large.  An expert stack (L, E, d, f) keeps per-(layer, column)
    statistics over all E * d rows of the layer, as the reference's
    ``_stats_axes`` (0, 3)."""
    if dist == "empirical":
        return _quantize_leaf_empirical(leaf, bits, stacked)
    if not stacked:
        qt = quantize_tensor(leaf, bits, per_channel=per_channel)
        return {"q_codes": qt.codes, "q_mu": qt.mu, "q_sigma": qt.sigma}
    parts = [quantize_tensor(leaf[l:l + 1], bits, per_channel=per_channel,
                             stacked=True) for l in range(leaf.shape[0])]
    return {"q_codes": torch.cat([p.codes for p in parts]),
            "q_mu": torch.cat([p.mu for p in parts]),
            "q_sigma": torch.cat([p.sigma for p in parts])}


def _eligible(path: str, leaf, bits: int, quant_filter) -> bool:
    return quant_filter(path, leaf) and not (bits == 4
                                             and leaf.shape[-1] % 2)


@torch.no_grad()
def quantize_params_for_serving(params, bits: int, quant_filter=None,
                                per_channel: bool = True,
                                dist: str = "gaussian",
                                stacked_prefixes=_STACKED_PREFIXES,
                                device="cuda"):
    """Replace eligible weight leaves by k-quantile code dicts on
    ``device``: ``{"q_codes", "q_mu", "q_sigma"}`` (dist="gaussian",
    analytic levels) or ``{"q_codes", "q_lut"}`` (dist="empirical",
    per-tensor empirical quantiles and their codebook).  Only int4 packing
    needs an even trailing dim, so the odd-last-dim skip applies at
    bits == 4 alone."""
    if dist not in ("gaussian", "empirical"):
        raise ValueError(f"dist must be gaussian|empirical, got {dist!r}")
    dev = resolve_device(device)
    quant_filter = quant_filter or default_quant_filter
    out: Dict[str, Any] = {}
    for keys, leaf in _walk(params):
        p = path_str(keys)
        if is_qweight(leaf):
            _set(out, keys, {k: v.to(dev) for k, v in leaf.items()})
        elif not _eligible(p, leaf, bits, quant_filter):
            _set(out, keys, leaf.to(dev))
        else:
            stacked = any(p.startswith(pre) for pre in stacked_prefixes)
            _set(out, keys, _quantize_leaf(leaf.to(dev), bits, per_channel,
                                           stacked, dist))
    return out


def norm_param(cfg: ArchConfig, *shape, device="cpu"):
    """Norm parameter(s): dict for LayerNorm, bare scale for RMSNorm."""
    if cfg.norm_kind == "layer":
        return {"scale": torch.ones(shape, dtype=torch.float32,
                                    device=device),
                "bias": torch.zeros(shape, dtype=torch.float32,
                                    device=device)}
    return torch.ones(shape, dtype=torch.float32, device=device)


def weight_drawer(seed: int, device, w_bits: int = 16,
                  dense_dtype=torch.float32, per_channel: bool = True,
                  w_dist: str = "gaussian"):
    """``(weight, gen, dev)``: ``weight(path, shape, init, stacked,
    dtype=dense_dtype, **kw)`` draws one parameter leaf from ``gen`` (a
    ``torch.Generator`` on ``dev`` seeded with ``seed``) by ``init``
    (``dense_init`` / ``embed_init``).  A stacked leaf is drawn one layer
    slice at a time.  With ``w_bits`` 4 or 8 each slice that
    ``default_quant_filter`` selects is k-quantile coded (``w_dist``
    "gaussian" or "empirical") as soon as it is drawn, and freed before the
    next is drawn, so a full-width model never holds a dense stacked leaf;
    the codes equal ``quantize_params_for_serving`` of the dense draw.
    Leaves left dense are stored in ``dtype``."""
    if w_dist not in ("gaussian", "empirical"):
        raise ValueError(f"w_dist must be gaussian|empirical, got "
                         f"{w_dist!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    quant = w_bits < 16

    def weight(path, shape, init, stacked, dtype=dense_dtype, **kw):
        probe = torch.empty((1,) * len(shape)).expand(shape)
        code = quant and _eligible(path, probe, w_bits, default_quant_filter)
        if not stacked:
            w = init(gen, shape, device=dev, **kw)
            return _quantize_leaf(w, w_bits, per_channel, False, w_dist) \
                if code else w.to(dtype)
        out = None                  # the stacked leaf, filled layer by layer
        for l in range(shape[0]):
            w = init(gen, (1,) + tuple(shape[1:]), device=dev, **kw)
            part = _quantize_leaf(w, w_bits, per_channel, True, w_dist) \
                if code else {"w": w.to(dtype)}
            del w                   # before the next layer's slice is drawn
            if out is None:
                out = {k: v.new_empty((shape[0],) + tuple(v.shape[1:]))
                       for k, v in part.items()}
            for k, v in part.items():
                out[k][l:l + 1].copy_(v)
            del part
        return out if code else out["w"]

    return weight, gen, dev


@torch.no_grad()
def init_params(seed: int, cfg: ArchConfig, device="cuda", w_bits: int = 16,
                dense_dtype=torch.float32, per_channel: bool = True,
                w_dist: str = "gaussian") -> Dict[str, Any]:
    """Random dense-decoder parameter tree on ``device``, from ``seed``
    (the vlm family's too: its patch embeddings come precomputed, so its
    tree is the dense one).

    Matmul weights are drawn one layer at a time (``weight_drawer``): with
    ``w_bits`` 4 or 8 each eligible layer slice is coded as soon as it is
    drawn (nor are two f32 layer slices of an expert stack held at once:
    22.5 GB each at kimi_k2), and the result equals
    ``quantize_params_for_serving(init_params(seed, cfg), w_bits,
    dist=w_dist)``.  Leaves left dense are stored in ``dense_dtype``,
    except the MoE ``router``, which stays f32.
    """
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: lm.init_params draws the dense, moe "
            f"and vlm families (ssm / hybrid: models/hybrid.py; audio: "
            f"models/encdec.py)")
    weight, _, dev = weight_drawer(seed, device, w_bits, dense_dtype,
                                   per_channel, w_dist)
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    layers: Dict[str, Any] = {
        "attn_norm": norm_param(cfg, L, d, device=dev),
        "wq": weight("layers/wq", (L, d, H * hd), dense_init, True),
        "wk": weight("layers/wk", (L, d, KV * hd), dense_init, True),
        "wv": weight("layers/wv", (L, d, KV * hd), dense_init, True),
        "wo": weight("layers/wo", (L, H * hd, d), dense_init, True),
        "mlp_norm": norm_param(cfg, L, d, device=dev),
    }
    if cfg.post_norms:
        layers["post_attn_norm"] = torch.ones((L, d), device=dev)
        layers["post_mlp_norm"] = torch.ones((L, d), device=dev)
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = weight("layers/router", (L, d, E), dense_init,
                                  True, dtype=torch.float32)
        layers["eg"] = weight("layers/eg", (L, E, d, f), dense_init, True)
        layers["eu"] = weight("layers/eu", (L, E, d, f), dense_init, True)
        layers["ed"] = weight("layers/ed", (L, E, f, d), dense_init, True,
                              in_axis=-2)
    else:
        layers["w_gate"] = weight("layers/w_gate", (L, d, f), dense_init,
                                  True)
        layers["w_up"] = weight("layers/w_up", (L, d, f), dense_init, True)
        layers["w_down"] = weight("layers/w_down", (L, f, d), dense_init,
                                  True)

    params: Dict[str, Any] = {
        "embed": weight("embed", (V, d), embed_init, False),
        "layers": layers,
        "final_norm": norm_param(cfg, d, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = weight("lm_head", (d, V), dense_init, False)
    return params


def _layer_view(layers, l: int):
    """Layer ``l`` of the stacked tree, as views."""
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l]) for k, v in layers.items()}


def unstack_layers(params, n_layers: int, key: str = "layers"):
    """Shallow copy of ``params`` whose ``key`` stack ("layers", or the
    audio family's "enc_layers" / "dec_layers") is a list of per-layer view
    dicts (``unbind``: no data is copied).  The forward passes take either
    form; a long-lived caller such as the engine unstacks once instead of
    slicing every leaf on every call.  Under autograd, ``unbind`` has one
    backward that stacks the L slices' gradients, where indexing each layer
    would build and sum L zero-padded gradients of the full stacked leaf."""
    def cut(v):
        return v.unbind(0)[:n_layers]

    cols = {k: ({kk: cut(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else cut(v)) for k, v in params[key].items()}
    out = dict(params)
    out[key] = [{k: ({kk: vv[l] for kk, vv in c.items()}
                     if isinstance(c, dict) else c[l])
                 for k, c in cols.items()} for l in range(n_layers)]
    return out


def _layer(params, l: int, key: str = "layers"):
    layers = params[key]
    return layers[l] if isinstance(layers, list) \
        else _layer_view(layers, l)


# --------------------------------------------------------------------------
# Layer body
# --------------------------------------------------------------------------

def _norm(x, scale_or_dict, cfg: ArchConfig):
    if cfg.norm_kind == "layer":
        return layer_norm(x, scale_or_dict["scale"], scale_or_dict["bias"],
                          cfg.norm_eps)
    zc = cfg.post_norms  # gemma-2 convention: zero-centered scales
    return rms_norm(x, scale_or_dict, cfg.norm_eps, zero_centered=zc)


def _window_schedule(cfg: ArchConfig) -> List[Optional[int]]:
    """Per-layer attention window; None = global."""
    w = np.full((cfg.n_layers,), BIG_WINDOW, np.int64)
    if cfg.sliding_window and cfg.local_global_alternate:
        w[0::2] = cfg.sliding_window      # even layers local (gemma-2)
    elif cfg.sliding_window:
        w[:] = cfg.sliding_window
    return [None if x >= BIG_WINDOW else int(x) for x in w]


def _qkv_placed(hn, lp, cfg: ArchConfig, opts: ModelOpts):
    """q, k, v of the rank's heads on a mesh: each projection
    column-parallel, then the heads the rank attends
    (``tensor_parallel.head_plan``)."""
    B, S, _ = hn.shape
    hd = cfg.head_dim
    plan = tpar.head_plan(cfg, opts)
    out = []
    for key in ("wq", "wk", "wv"):
        t, split = tpar.column_mm(hn, lp[key],
                                  tpar.leaf_spec(opts, f"layers/{key}"),
                                  opts)
        t = tpar.q_heads(t, split, plan, opts) if key == "wq" \
            else tpar.kv_heads(t, split, plan, hd, opts)
        out.append(t.reshape(B, S, -1, hd))
    return out


def _qkv(hn, lp, cfg: ArchConfig, opts: ModelOpts, positions, cos_sin):
    """Projections + RoPE; ``cos_sin`` are the call's rotation tables.  On
    a mesh (``opts.placement``) the rank's heads (``_qkv_placed``)."""
    B, S, _ = hn.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if _placed(opts):
        q, k, v = _qkv_placed(hn, lp, cfg, opts)
    else:
        q = mm_a(hn, lp["wq"], opts).reshape(B, S, H, hd)
        k = mm_a(hn, lp["wk"], opts).reshape(B, S, KV, hd)
        v = mm_a(hn, lp["wv"], opts).reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cos_sin)
    k = apply_rope(k, positions, cfg.rope_theta, cos_sin)
    return q, k, v


def _qkv_mm(hn, lp, cfg: ArchConfig, opts: ModelOpts, positions, cos_sin):
    """``_qkv`` through ``mm``, without the serving activation codec: the
    projections of zamba2's shared block and of whisper, which the
    reference computes so (the engine, which sets ``serve_a_bits``, serves
    neither)."""
    B, S, _ = hn.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    uk = opts.use_kernels
    q = apply_rope(mm(hn, lp["wq"], uk).reshape(B, S, H, hd), positions,
                   cfg.rope_theta, cos_sin)
    k = apply_rope(mm(hn, lp["wk"], uk).reshape(B, S, KV, hd), positions,
                   cfg.rope_theta, cos_sin)
    v = mm(hn, lp["wv"], uk).reshape(B, S, KV, hd)
    return q, k, v


def _attn_out(o, lp, cfg: ArchConfig, opts: ModelOpts):
    """(B, S, heads, hd) -> (B, S, d) through wo; on a mesh the rank's
    heads are its block of wo's rows where they are its own (row-parallel,
    the partial sums all-reduced)."""
    B, S, h = o.shape[:3]
    o = o.reshape(B, S, h * cfg.head_dim)
    if _placed(opts):
        o = tpar.row_mm(o, tpar.head_plan(cfg, opts).q_local, lp["wo"],
                        tpar.leaf_spec(opts, "layers/wo"), opts)
    else:
        o = mm_a(o, lp["wo"], opts)
    if cfg.post_norms:
        o = _norm(o, lp["post_attn_norm"], cfg)
    return o


def _attn_block(x, lp, cfg: ArchConfig, opts: ModelOpts, positions, window,
                cos_sin, kv_out: bool = False):
    """Self-attention sub-block on (B, S, d).  Returns (out, kv).

    ``kv`` (when requested) is ``(k, v)`` dense, or the k-quantile code
    dict when ``opts.kv_bits < 16``: serving prefill then fake-quantizes
    K/V *before* attending, so the queries see exactly the dequantized
    rows a later incremental decode reads from the paged pool.  From S =
    ``opts.attn_chunked_min_len`` on it attends in KV chunks
    (``attn.attend``), for every caller (training and prefill).
    """
    h = _norm(x, lp["attn_norm"], cfg)
    q, k, v = _qkv(h, lp, cfg, opts, positions, cos_sin)
    kv = None
    if kv_out:
        if opts.kv_bits < 16:
            # K and V are coded in one pass (rows are coded independently)
            dq, st, mu, sig = kvq.fake_quant_kv(torch.stack([k, v]),
                                                opts.kv_bits,
                                                opts.use_kernels)
            k, v = dq[0], dq[1]
            kv = {"k_codes": st[0], "v_codes": st[1],
                  "k_mu": mu[0], "k_sigma": sig[0],
                  "v_mu": mu[1], "v_sigma": sig[1]}
        else:
            kv = {"k": k, "v": v}
    p = attn.AttnParams(window=window, logit_cap=cfg.attn_logit_cap,
                        causal=True)
    pos1d = positions[0]
    o = attn.attend(q, k, v, pos1d, pos1d, p, opts)
    return _attn_out(o, lp, cfg, opts), kv


def _ep_block(w, mesh, f_axis: int = 0, fa: tuple = ()):
    """This rank's block of a layer's expert weight — dense (E, a, b) or its
    coded dict — cut out of the whole leaf: the experts over ``model``, and
    with ``fa`` dim ``f_axis`` over those axes, each leaf where its dim
    divides (statistics' size-1 dims stay whole; the (k,) codebook too).
    The weight itself (its codes) must split over ``fa``, or it raises."""
    sizes = shd.axis_sizes(mesh)
    fa_n = math.prod(sizes[a] for a in fa)

    def one(leaf, main):
        if leaf.ndim < 3:
            return leaf
        spec = [None, None, None]
        if leaf.shape[0] % sizes["model"] == 0:
            spec[0] = "model"
        if fa and leaf.shape[f_axis] % fa_n == 0:
            spec[f_axis] = fa
        elif fa and main:
            raise ValueError(f"moe_mode 'reduce': an expert weight's d_ff "
                             f"({leaf.shape[f_axis]}) does not split over "
                             f"{fa} ({fa_n})")
        return shd.Sharding(mesh, shd.P(*spec)).place(leaf).contiguous()

    if is_qweight(w):
        return {k: one(v, k == "q_codes") for k, v in w.items()}
    return one(w, True)


def _moe_ep_sharded(h, router_w, eg, eu, ed, mcfg, opts: ModelOpts):
    """Expert-parallel MoE over ``opts.mesh`` (the reference's shard_map
    region, written out on each rank's blocks).

    Experts are split over ``model`` (E_l = E / tp per rank).  Every rank
    holds every weight whole (``param_shardings``' blocks are not fed to
    the model), so the region cuts its blocks out of the whole tensors, as
    shard_map takes them from replicated operands, and hands the result
    back whole.  The reference's two FSDP layouts of the expert weights
    over ``opts.fsdp_axes``:

    gather: the reference all-gathers the d-slices per layer, which gives
      back the rank's whole experts: here the rank takes them directly (no
      weight moves).  The tokens split over the DP axes; each rank's
      experts on its tokens, summed over ``model`` (``moe.moe_ffn(group=)``).
    reduce: d_ff stays split; every rank computes a partial-f SwiGLU of
      its tokens (split over the DP axes not in the FSDP ones: silu and the
      product are elementwise in f, so partial-f is exact) and the partial
      outputs are summed over ("model",) + fsdp axes.  No weight moves.

    A coded stack stays coded: its f-slice is a slice of the packed codes'
    bytes (eg / eu: f is their last dim) or of ed's rows, through
    ``qmatmul_experts`` / ``qmatmul_lut_experts`` on the rank's block."""
    mesh = opts.mesh
    sizes = shd.axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes
               and a not in opts.manual_axes)
    fa = tuple(a for a in opts.fsdp_axes if a in sizes)
    reduce = opts.moe_mode == "reduce" and fa
    if reduce:
        dp = tuple(a for a in dp if a not in fa)
    B = h.shape[0]
    bspec = dp if dp and B % math.prod(sizes[a] for a in dp) == 0 else None
    hb = shd.Sharding(mesh, shd.P(bspec, None, None)).place(h) \
        if bspec else h
    groups = {a: mesh.get_group(a) for a in sizes}
    if reduce:
        g, u, dn = (_ep_block(w, mesh, ax, fa)
                    for w, ax in ((eg, 2), (eu, 2), (ed, 1)))
        B_, S_, d_ = hb.shape
        y = moe_lib.moe_ffn_local(
            hb.reshape(B_ * S_, d_), router_w, g, u, dn, mcfg,
            act_fn=F.silu, use_kernels=opts.use_kernels,
            shard_idx=shd.mesh_coords(mesh)["model"],
            n_shards=sizes["model"])
        y = coll.all_reduce(y, [groups[a] for a in ("model",) + fa])
        y = y.reshape(B_, S_, d_)
    else:
        g, u, dn = (_ep_block(w, mesh) for w in (eg, eu, ed))
        y = moe_lib.moe_ffn(hb, router_w, g, u, dn, mcfg, act_fn=F.silu,
                            use_kernels=opts.use_kernels,
                            group=groups["model"])
    if bspec:
        y = coll.all_gather(y, [groups[a] for a in bspec], dim=0)
    return y


def _ffn_block(x, lp, cfg: ArchConfig, opts: ModelOpts):
    h = _norm(x, lp["mlp_norm"], cfg)
    if cfg.is_moe:
        # the reference's MoE branch: f32 router, expert stacks in the
        # compute dtype (never through mm_a: serve_a_bits leaves them alone)
        mcfg = moe_lib.MoEConfig(cfg.n_experts, cfg.top_k,
                                 cfg.capacity_factor)
        router_w = materialize(lp["router"], torch.float32, opts.use_kernels)
        if opts.moe_axis and opts.mesh is not None:
            o = _moe_ep_sharded(h, router_w, lp["eg"], lp["eu"], lp["ed"],
                                mcfg, opts)
        else:
            o = moe_lib.moe_ffn(h, router_w, lp["eg"], lp["eu"], lp["ed"],
                                mcfg, act_fn=F.silu,
                                use_kernels=opts.use_kernels)
    elif _placed(opts):
        # column-parallel gate / up, row-parallel down (the rank's d_ff
        # columns, where they split over "model")
        (g, gs), (u, us) = (tpar.column_mm(
            h, lp[k], tpar.leaf_spec(opts, f"layers/{k}"), opts)
            for k in ("w_gate", "w_up"))
        if gs != us:
            raise ValueError("w_gate and w_up are split differently")
        g = F.silu(g) if cfg.mlp_act == "silu" \
            else F.gelu(g, approximate="tanh")
        o = tpar.row_mm(g * u, gs, lp["w_down"],
                        tpar.leaf_spec(opts, "layers/w_down"), opts)
    else:
        g = mm_a(h, lp["w_gate"], opts)
        u = mm_a(h, lp["w_up"], opts)
        g = F.silu(g) if cfg.mlp_act == "silu" \
            else F.gelu(g, approximate="tanh")
        o = mm_a(g * u, lp["w_down"], opts)
    if cfg.post_norms:
        o = _norm(o, lp["post_mlp_norm"], cfg)
    return o


def _maybe_quant_act(x, opts: ModelOpts, rows=()):
    """Layer-output activation fake-quant at ``opts.a_bits`` < 32: a
    per-tensor absmax int-b round trip with a straight-through gradient
    (``core/activations.py:fake_quant_act``).  ``rows``: x is a rank's
    block of the batch over those axes; the absmax is the whole batch's."""
    if opts.a_bits < 32:
        scale = None
        if rows:
            scale = coll.all_reduce_max(act.act_scale(x, opts.a_bits),
                                        tpar.groups_of(opts, rows))
        return act.fake_quant_act(x, opts.a_bits, scale)
    return x


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def _embed_tokens(params, cfg: ArchConfig, opts: ModelOpts, tokens):
    emb = params["embed"]
    tok = tokens.to(torch.long)
    if _placed(opts):
        x = tpar.vocab_embed(emb, tpar.leaf_spec(opts, "embed"), tok,
                             opts.compute_dtype, opts)
    elif is_qweight(emb):
        # gather the token rows of the codes, dequantize only those: the
        # same values as dequantizing the whole table and then gathering
        rows = dict(emb, q_codes=emb["q_codes"][tok])
        x = materialize(rows, opts.compute_dtype, opts.use_kernels)
    else:
        x = emb[tok].to(opts.compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _head_weight(params, cfg: ArchConfig, use_kernels: bool = True):
    if cfg.tie_embeddings:
        emb = params["embed"]
        if is_qweight(emb):
            # tied quantized embedding: dequantize (through bf16) then
            # transpose
            return materialize(emb, torch.bfloat16, use_kernels).T
        return emb.T
    return params["lm_head"]


def _logits(last, params, cfg: ArchConfig, opts: ModelOpts):
    """(B, d) final hidden rows -> (B, V) f32 logits (on a mesh the rank's
    vocabulary columns, then gathered whole)."""
    if _placed(opts):
        w, split = tpar.head_weight(params, cfg, opts)
        logits = softcap(tpar.vocab_logits(last, w, split, opts),
                         cfg.final_logit_cap)
        return tpar.gather_vocab(logits, split, opts)
    logits = mm(last, _head_weight(params, cfg, opts.use_kernels),
                opts.use_kernels, out_dtype=torch.float32)
    return softcap(logits, cfg.final_logit_cap)


def _norm_final(x, params, cfg: ArchConfig):
    fn = params["final_norm"]
    if cfg.norm_kind == "layer":
        return layer_norm(x, fn["scale"], fn["bias"], cfg.norm_eps)
    return rms_norm(x, fn, cfg.norm_eps, zero_centered=cfg.post_norms)


# --------------------------------------------------------------------------
# Training forward + loss
# --------------------------------------------------------------------------

def _seq_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (>=1)."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def chunked_ce_loss(x, head_w, targets, cfg: ArchConfig, opts: ModelOpts,
                    split: bool = False, rows=()):
    """Cross-entropy without materializing (B, S, V) logits at once.

    x (B, S, d), targets (B, S) int with -1 = ignore.  Loops over sequence
    chunks of ``_seq_chunk(S, opts.ce_chunk)`` positions; logits are f32.
    On a mesh (``opts.placement``) ``head_w`` holds the rank's vocabulary
    columns where ``split`` and the logits stay split
    (``tensor_parallel.vocab_ce``); x is the rank's rows of the batch over
    ``rows``, and the loss is the whole batch's: the sum and the count of
    valid targets all-reduced over them, then divided (the ranks' blocks
    hold different counts).
    """
    B, S, d = x.shape
    chunk = _seq_chunk(S, opts.ce_chunk)
    total = x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    placed = _placed(opts)
    for i in range(0, S, chunk):
        xb, tb = x[:, i:i + chunk], targets[:, i:i + chunk].to(torch.long)
        if placed:
            logits = softcap(tpar.vocab_logits(xb, head_w, split, opts),
                             cfg.final_logit_cap)
            per = tpar.vocab_ce(logits, tb, split, opts)
        else:
            logits = mm(xb, head_w, opts.use_kernels,
                        out_dtype=torch.float32)
            logits = softcap(logits, cfg.final_logit_cap)
            lse = torch.logsumexp(logits, dim=-1)                # (B, c)
            gold = torch.gather(logits, -1,
                                tb.clamp_min(0)[..., None])[..., 0]
            per = lse - gold
        valid = (tb >= 0).to(torch.float32)
        total = total + torch.sum(per * valid)
        count = count + torch.sum(valid)
    if not placed:
        return total / torch.clamp(count, min=1.0)
    g = tpar.groups_of(opts, rows)
    if g:
        total = coll.sum_reduce(total, g)
        count = coll.all_reduce(count.detach(), g)
    loss = total / torch.clamp(count, min=1.0)
    # a data-parallel axis the batch does not split computes the same loss
    # on each of its ranks: each takes its share of the gradient, so that
    # the sums over the axis (the FSDP reduce-scatters, sync_grads) are the
    # loss's
    sizes = shd.axis_sizes(opts.mesh)
    n_rep = math.prod(sizes[a] for a in tpar.data_axes(opts)
                      if a not in rows)
    if n_rep > 1:
        loss = loss.detach() + (loss - loss.detach()) / n_rep
    return loss


def rope_positions(B: int, S: int, cfg: ArchConfig, device):
    """Positions 0 .. S-1 of B rows (B, S) and their RoPE (cos, sin)."""
    positions = torch.arange(S, device=device)[None].expand(B, S)
    return positions, rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def apply_layer(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` (and autograd on) its activations are
    recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return _ckpt.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# the matmul weights of a layer that the per-layer UNIQ transform covers
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "eg", "eu", "ed")


def _uniq_layer(lp, uniq_scan, l: int, use_kernel: bool):
    """Layer ``l``'s weights through the UNIQ transform (``uniq_scan``, the
    reference's ``_uniq_layer``): each dense ``_QUANT_KEYS`` leaf of the
    layer with the layer's mode and per-tensor statistics over the whole
    slice (layer l's of the stack's, ``fit_layers``, where the layers came
    stacked), its noise drawn for this (leaf, layer) alone.  Called inside
    the function ``apply_layer`` checkpoints, so under remat the
    transformed copy is recomputed in the backward pass (the same keyed
    draw gives the same bits) and one layer's copy is live at a time."""
    if uniq_scan is None:
        return lp
    ucfg, modes, noise, stats = uniq_scan
    out = dict(lp)
    for key in _QUANT_KEYS:
        if key in lp and not is_qweight(lp[key]):
            m = stats.get(key)
            out[key] = transform_param(
                lp[key], noise(key, l, lp[key]), modes[l], ucfg,
                stacked=False, use_kernel=use_kernel,
                model=None if m is None else GaussianModel(mu=m.mu[l],
                                                           sigma=m.sigma[l]))
    return out


def _train_layer(x, lp, cfg: ArchConfig, opts: ModelOpts, positions, window,
                 cos_sin, uniq_scan=None, l: int = 0, rows=()):
    lp = _uniq_layer(lp, uniq_scan, l, opts.use_kernels)
    a, _ = _attn_block(x, lp, cfg, opts, positions, window, cos_sin)
    x = x + a
    x = x + _ffn_block(x, lp, cfg, opts)
    return _maybe_quant_act(x, opts, rows)


def _rows_of(batch, opts: ModelOpts, keys):
    """(the batch with this rank's rows of ``keys``, the axes they split
    over): ``shard_act``'s "dp" of the rows on a mesh, the batch as it is
    without one."""
    if not _placed(opts):
        return batch, ()
    rows = tpar.batch_axes(opts, batch[keys[0]].shape[0])
    out = dict(batch)
    for k in keys:
        if k in batch and batch[k] is not None:
            out[k] = tpar.take_rows(torch.as_tensor(batch[k]), opts, rows)
    return out, rows


def forward_train(params, cfg: ArchConfig, opts: ModelOpts, batch,
                  uniq_scan=None):
    """Teacher-forced LM loss (a differentiable scalar; cross-entropy alone,
    at the MoE family too, as in the reference).  batch: tokens / targets
    (B, S), and at the vlm family ``patch_embeds`` (B, P, d), cast to the
    compute dtype and put ahead of the tokens: positions run over the P + S
    rows and the loss covers the token rows only.  With ``opts.remat`` each
    layer is recomputed in the backward pass instead of keeping its
    activations.

    ``uniq_scan = (UniqConfig, (L,) host modes, noise)`` applies the UNIQ
    transform per layer inside the layer loop (``_uniq_layer``);
    ``noise(key, layer, leaf)`` gives a layer's leaf its U[0, 1) draw
    (``core/uniq.py:layer_noise``).  The statistics of stacked layers are
    fitted here, once, as the whole-tree transform fits them.

    On a mesh (``opts.placement``) the parameters are the rank's blocks and
    the batch is whole: the rank takes its rows, the statistics are the
    whole leaves', each layer's noise the whole draw's block, and the loss
    the whole batch's (``chunked_ce_loss``)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r}: lm.forward_train trains the dense, "
            f"moe and vlm families (ssm / hybrid: models/hybrid.py; audio: "
            f"models/encdec.py)")
    batch, rows = _rows_of(batch, opts, ("tokens", "targets",
                                         "patch_embeds"))
    if uniq_scan is not None:
        ucfg, modes, noise = uniq_scan
        pl = opts.placement
        stats = {} if isinstance(params["layers"], list) else {
            k: fit_layers(v, ucfg, pl, f"layers/{k}")
            for k, v in params["layers"].items()
            if k in _QUANT_KEYS and not is_qweight(v)}
        if pl is not None:
            noise = tpar.whole_layer_noise(noise, pl)
        uniq_scan = (ucfg, modes, noise, stats)
    if not isinstance(params["layers"], list):
        params = unstack_layers(params, cfg.n_layers)
    x = _embed_tokens(params, cfg, opts, batch["tokens"])
    n_patches = 0
    if cfg.family == "vlm":
        pe = batch["patch_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([pe, x], dim=1)
        n_patches = pe.shape[1]
    B, S, _ = x.shape
    positions, cos_sin = rope_positions(B, S, cfg, x.device)
    windows = _window_schedule(cfg)
    for l in range(cfg.n_layers):
        x = apply_layer(_train_layer, opts.remat, x, _layer(params, l), cfg,
                        opts, positions, windows[l], cos_sin, uniq_scan, l,
                        rows)
    x = _norm_final(x, params, cfg)
    if n_patches:
        x = x[:, n_patches:]
    if _placed(opts):
        w, split = tpar.head_weight(params, cfg, opts)
        return chunked_ce_loss(x, w, batch["targets"], cfg, opts, split,
                               rows)
    return chunked_ce_loss(x, _head_weight(params, cfg, opts.use_kernels),
                           batch["targets"], cfg, opts)


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------

@torch.no_grad()
def forward_prefill(params, cfg: ArchConfig, opts: ModelOpts, batch,
                    pad_to: Optional[int] = None,
                    last_idx: Optional[torch.Tensor] = None):
    """Prefill: run the prompt, emit last-position logits + per-layer KV.

    Returns (logits (B, V), cache dict of (L, B, S, ...) leaves: dense
    {"k","v"} or codes + stats at ``opts.kv_bits < 16``).  ``last_idx`` (B,)
    selects a per-sequence "last" position instead of S-1 (right-padded
    prompt groups; padding beyond last_idx is inert under the causal mask).
    At the vlm family ``batch["patch_embeds"]`` (B, P, d), cast to the
    compute dtype, goes ahead of the token embeddings: positions, the cache
    and ``last_idx`` run over the P + S rows.

    On a mesh (``opts.placement``) the batch is whole: the rank computes
    its rows (``shard_act``'s "dp") and heads; the logits come back whole
    on every rank, the cache is the rank's block (its rows, its KV heads).
    """
    batch = dict(batch, last_idx=last_idx)
    batch, rows = _rows_of(batch, opts, ("tokens", "patch_embeds",
                                         "last_idx"))
    last_idx = batch["last_idx"]
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, opts, tokens)
    if cfg.family == "vlm":
        pe = batch["patch_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    positions, cos_sin = rope_positions(B, S, cfg, x.device)
    windows = _window_schedule(cfg)
    kvs = []
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        a, kv = _attn_block(x, lp, cfg, opts, positions, windows[l],
                            cos_sin, kv_out=True)
        x = x + a
        x = x + _ffn_block(x, lp, cfg, opts)
        x = _maybe_quant_act(x, opts, rows)
        kvs.append(kv)
    x = _norm_final(x, params, cfg)
    if last_idx is None:
        last = x[:, -1]
    else:
        idx = torch.clamp(last_idx.to(torch.long), 0, S - 1)
        last = x[torch.arange(B, device=x.device), idx]
    logits = tpar.gather_rows(_logits(last, params, cfg, opts), opts, rows)
    cache = {name: torch.stack([kv[name] for kv in kvs]) for name in kvs[0]}
    if pad_to and pad_to > S:
        # every cache leaf is (L, B, S, ...): pad the position axis
        def pad(leaf):
            shape = list(leaf.shape)
            shape[2] = pad_to - S
            return torch.cat([leaf, leaf.new_zeros(shape)], dim=2)
        cache = {name: pad(leaf) for name, leaf in cache.items()}
    return logits, cache


def _cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    return (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)


def placed_cache_shape(cfg: ArchConfig, batch: int, max_len: int,
                       opts: Optional[ModelOpts] = None):
    """The slot cache's (L, B, S, KV, hd), on a mesh (``opts.placement``)
    the rank's block: its rows of the batch (``shard_act``'s "dp") and the
    KV heads it attends (``tensor_parallel.head_plan``: the heads over
    "model", where the reference's ``cache_shardings`` puts the sequence;
    the numbers are the same)."""
    if opts is None or not _placed(opts):
        return _cache_shape(cfg, batch, max_len)
    rows = tpar.batch_axes(opts, batch)
    sizes = shd.axis_sizes(opts.mesh)
    return (cfg.n_layers, batch // math.prod(sizes[a] for a in rows),
            max_len, tpar.head_plan(cfg, opts).kv_n, cfg.head_dim)


@torch.no_grad()
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda",
               opts: Optional[ModelOpts] = None):
    """Zeroed slot KV cache {"k","v"} (L, B, S, KV, hd) on ``device``: one
    fixed region of ``max_len`` rows per batch row, written positionally by
    ``decode_step`` without block tables.  On a mesh (``opts.placement``)
    the rank's block (``placed_cache_shape``)."""
    dev = resolve_device(device)
    shape = placed_cache_shape(cfg, batch, max_len, opts)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """The slot cache's shapes and dtypes without memory: ``device="meta"``
    tensors (the counterpart of ``jax.ShapeDtypeStruct``)."""
    shape = _cache_shape(cfg, batch, max_len)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta")}


@torch.no_grad()
def init_paged_cache(cfg: ArchConfig, total_pages: int, page_size: int,
                     dtype=torch.bfloat16, kv_bits: int = 16,
                     device="cuda", opts: Optional[ModelOpts] = None):
    """Zeroed paged KV pool on ``device``, bit-width-parametric.

    kv_bits=16: dense {"k","v"} (L, total_pages, page_size, KV, hd).
    kv_bits=8/4: k-quantile codes {"k_codes","v_codes"} (int8, or uint8
    packed two-per-byte along hd for 4-bit) plus per-(row, head) bf16
    statistics {"k_mu","k_sigma","v_mu","v_sigma"} of shape
    (L, total_pages, page_size, KV).

    Page 0 is the reserved *sink*: never allocated to a sequence, it
    absorbs the writes of inactive decode rows and prefill right-padding
    (block-table entries default to 0), so scatters never need a mask.
    On a mesh (``opts.placement``) every rank holds every page of the KV
    heads it attends (``tensor_parallel.head_plan``).
    """
    kvq.check_kv_bits(kv_bits, cfg.head_dim)
    dev = resolve_device(device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if opts is not None and _placed(opts):
        KV = tpar.head_plan(cfg, opts).kv_n
    if kv_bits == 16:
        shape = (L, total_pages, page_size, KV, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
    code_shape = (L, total_pages, page_size, KV,
                  hd // 2 if kv_bits == 4 else hd)
    code_dtype = packing.storage_dtype(kv_bits)
    stat_shape = (L, total_pages, page_size, KV)
    stats = {name: torch.zeros(stat_shape, dtype=kvq.STATS_DTYPE, device=dev)
             for name in ("k_mu", "k_sigma", "v_mu", "v_sigma")}
    return {"k_codes": torch.zeros(code_shape, dtype=code_dtype, device=dev),
            "v_codes": torch.zeros(code_shape, dtype=code_dtype, device=dev),
            **stats}


@torch.no_grad()
def cache_insert_paged(cache, prefill_cache, page_tables):
    """Scatter a prefill KV block into the paged pool, in place.

    cache         : pool from ``init_paged_cache`` (any kv_bits layout).
    prefill_cache : matching dict of (L, G, S_pad, ...) leaves from a
                    padded batched prefill of G admitted prompts.
    page_tables   : (G, n_pages) destination page ids covering
                    [0, n_pages * page_size); entries past a prompt's
                    allocated pages (and whole pad rows) are 0 (sink).

    Rows past a prompt's true length hold right-padding garbage but land
    in the sink page or in the tail of the sequence's last page, where
    decode's write-before-read keeps them invisible.  Duplicate sink
    entries overwrite each other in no particular order; the sink is only
    ever read under the mask.
    """
    ref_pool = next(iter(cache.values()))
    page = ref_pool.shape[2]
    pt = torch.as_tensor(page_tables, device=ref_pool.device).to(torch.long)
    n_pages = pt.shape[1]
    for name, pool in cache.items():
        kv = prefill_cache[name]
        L, G, s_pad = kv.shape[:3]
        pad = n_pages * page - s_pad
        if pad:
            shape = list(kv.shape)
            shape[2] = pad
            kv = torch.cat([kv, kv.new_zeros(shape)], dim=2)
        kv = kv.reshape(L, G, n_pages, page, *kv.shape[3:])
        pool[:, pt] = kv.to(pool.dtype)
    return cache


def _write_rows(kc, layer: int, pages, rows, k, v, kv_bits: int,
                use_kernels: bool = True):
    """Write fresh K/V rows into layer ``layer`` of the pool at
    (pages, rows), in place; returns that layer's view of the pool."""
    view = {name: leaf[layer] for name, leaf in kc.items()}
    if kvq.is_quantized_cache(kc):
        # one fused kernel codes K and V and writes all six leaves
        kvq.append_kv(view, pages, rows, k, v, kv_bits, use_kernels)
        return view
    for name, val in (("k", k), ("v", v)):
        view[name][pages, rows] = val.to(view[name].dtype)
    return view


@torch.no_grad()
def prefill_chunk(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
                  positions, write_pages, write_rows, block_tables,
                  last_idx):
    """Chunked prefill: run the next C prompt tokens of B sequences against
    (and into) the paged pool.

    tokens       : (B, C) token ids (right-padded; pad rows compute garbage
                   that lands in the sink).
    positions    : (C,) shared, or (B, C) per-sequence absolute positions.
    write_pages / write_rows : same shape as ``positions`` — pool
                   destination of each row's KV; pad rows point at the sink.
    block_tables : (B, n_pages) each sequence's full block-table row.
    last_idx     : () or (B,) index of each prompt's last token within the
                   chunk (meaningful on the final chunk).

    Each layer scatters the chunk's fresh KV into the pool *before*
    attending, then attends over the gathered block-table row under the
    causal mask.  Returns (logits (B, V) at ``last_idx``, the pool).
    """
    dev = next(iter(cache.values())).device
    tokens = torch.as_tensor(tokens, device=dev)
    B, C = tokens.shape
    x = _embed_tokens(params, cfg, opts, tokens)          # (B, C, d)
    positions = torch.as_tensor(positions, device=dev).to(torch.long)
    write_pages = torch.as_tensor(write_pages, device=dev).to(torch.long)
    write_rows = torch.as_tensor(write_rows, device=dev).to(torch.long)
    if positions.ndim == 1:                # single-sequence layout
        positions = positions[None].expand(B, C)
        write_pages = write_pages[None].expand(B, C)
        write_rows = write_rows[None].expand(B, C)
    block_tables = torch.as_tensor(block_tables, device=dev)
    last_idx = torch.atleast_1d(torch.as_tensor(last_idx, device=dev)) \
        .to(torch.long)
    windows = _window_schedule(cfg)
    cos_sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    quant = kvq.is_quantized_cache(cache)
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        hn = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(hn, lp, cfg, opts, positions, cos_sin)
        p = attn.AttnParams(window=windows[l], logit_cap=cfg.attn_logit_cap,
                            causal=True)
        kc = _write_rows(cache, l, write_pages, write_rows, k, v,
                         opts.kv_bits, opts.use_kernels)
        if quant:
            o = attn.paged_prefill_attention_quant(
                q, kc, block_tables, positions, p, kv_bits=opts.kv_bits,
                use_kernel=opts.use_kernels)
        else:
            o = attn.paged_prefill_attention(q, kc["k"], kc["v"],
                                             block_tables, positions, p)
        x = x + _attn_out(o, lp, cfg, opts)
        x = x + _ffn_block(x, lp, cfg, opts)
        x = _maybe_quant_act(x, opts)
    x = _norm_final(x, params, cfg)
    # (on a mesh every rank runs every sequence of the shared pool)
    last = x[torch.arange(B, device=dev),
             torch.clamp(last_idx, 0, C - 1).expand(B)]   # (B, d)
    return _logits(last, params, cfg, opts), cache


@torch.no_grad()
def decode_step(params, cfg: ArchConfig, opts: ModelOpts, cache, tokens,
                positions, block_tables=None):
    """One decode step.  tokens (B, 1); positions (B,) current index.

    cache: slot layout {"k","v"} (L, B, S, KV, hd) when ``block_tables``
    is None (``init_cache``): each batch row's fresh K/V row is written at
    its position, then ``attention.decode_attention`` attends over the
    row's region under the causal (and window) mask.  Paged layout (leaves
    (L, total_pages, page_size, ...), dense or k-quantile-coded — see
    ``init_paged_cache``) with ``block_tables`` (B, n_pages) page
    indirection otherwise: the fresh K/V row (coded per (row, head) at
    ``opts.kv_bits < 16``) goes into the pool *before* the step attends; at
    kv8/kv4 attention runs off the coded pool through the paged-attention
    kernel.  Either cache is updated in place.

    On a mesh (``opts.placement``) tokens and positions are whole: with the
    slot cache the rank computes its rows (the cache holds its block,
    ``placed_cache_shape``), with the paged pool every row; the logits come
    back whole on every rank.

    Returns (logits (B, V), the cache).
    """
    paged = block_tables is not None
    quant = kvq.is_quantized_cache(cache)
    if quant and not paged:
        raise ValueError("quantized KV cache requires the paged layout")
    dev = next(iter(cache.values())).device
    rows = ()
    if not paged:
        b, rows = _rows_of({"tokens": torch.as_tensor(tokens),
                            "positions": torch.as_tensor(positions)},
                           opts, ("tokens", "positions"))
        tokens, positions = b["tokens"], b["positions"]
        if _placed(opts) and tokens.shape[0] != cache["k"].shape[1]:
            raise ValueError(f"the cache holds {cache['k'].shape[1]} rows "
                             f"of the batch, this rank computes "
                             f"{tokens.shape[0]}")
    tokens = torch.as_tensor(tokens, device=dev)
    positions = torch.as_tensor(positions, device=dev).to(torch.long)
    x = _embed_tokens(params, cfg, opts, tokens)          # (B, 1, d)
    B = x.shape[0]
    pos2d = positions[:, None]
    windows = _window_schedule(cfg)
    if paged:
        block_tables = torch.as_tensor(block_tables, device=dev)
        page = next(iter(cache.values())).shape[2]
        write_page = torch.gather(block_tables.to(torch.long), 1,
                                  (positions // page)[:, None])[:, 0]
        write_row = positions % page
        bt32 = block_tables.to(torch.int32).contiguous()
        pos32 = positions.to(torch.int32)
    else:
        barange = torch.arange(B, device=dev)
    cos_sin = rope_cos_sin(pos2d, cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        hn = _norm(x, lp["attn_norm"], cfg)
        q, k, v = _qkv(hn, lp, cfg, opts, pos2d, cos_sin)
        p = attn.AttnParams(window=windows[l], logit_cap=cfg.attn_logit_cap,
                            causal=True)
        if not paged:
            kc = {name: leaf[l] for name, leaf in cache.items()}
            kc["k"][barange, positions] = k[:, 0].to(kc["k"].dtype)
            kc["v"][barange, positions] = v[:, 0].to(kc["v"].dtype)
            o = attn.decode_attention(q, kc["k"], kc["v"], positions, p)
        else:
            kc = _write_rows(cache, l, write_page, write_row, k[:, 0],
                             v[:, 0], opts.kv_bits, opts.use_kernels)
            if quant:
                o = attn.paged_decode_attention_quant(
                    q, kc, bt32, pos32, p, kv_bits=opts.kv_bits,
                    use_kernel=opts.use_kernels)
            else:
                o = attn.paged_decode_attention(q, kc["k"], kc["v"],
                                                block_tables, positions, p)
        x = x + _attn_out(o, lp, cfg, opts)
        x = x + _ffn_block(x, lp, cfg, opts)
        x = _maybe_quant_act(x, opts, rows)
    x = _norm_final(x, params, cfg)
    return tpar.gather_rows(_logits(x[:, 0], params, cfg, opts), opts,
                            rows), cache
