"""Bit-parametric KV-cache codec (kv_bits in {16, 8, 4}).

Each KV row is coded per (page row, head): one (mu, sigma) pair per written
token per KV head, stored in bf16 beside the codes.  Row granularity is what
makes preemption/resume bit-exact in the codes domain: a row's codes depend
only on that row's fresh K/V values.  Codes reuse the weight-path
conventions (``kernels/ref.py`` Phi/Phi^-1 pair, int4 two-per-byte packing,
int8 storage offset for k=256), so the paged-attention kernel shares the
qmatmul dequant formulation.  Coding and dense dequantization go through
the k-quantile codec kernels (``kernels/ops.py:quantize_weights`` /
``dequantize_weights``); the mean and deviation stay plain torch, as in the
reference, where they are inputs of the kernel.  The serving path's append
(``append_kv``) codes and writes a layer's fresh rows in one fused kernel
(``kernels/kquantile.py:kv_append``).  ``token_kv_bytes``/``page_kv_bytes``
give the exact pool bytes per token/page, the scheduler's admission
currency.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.kernels import kquantile as kq
from repro_torch.kernels import ops as kops

KV_BITS_CHOICES = (16, 8, 4)

# Per-row statistics dtype; codes are computed from the *rounded* stats so
# quantize and dequantize always agree bit-for-bit.
STATS_DTYPE = torch.bfloat16
STATS_BYTES = 2


def check_kv_bits(kv_bits: int, head_dim: int = 0) -> None:
    if kv_bits not in KV_BITS_CHOICES:
        raise ValueError(f"kv_bits must be one of {KV_BITS_CHOICES}, "
                         f"got {kv_bits}")
    if kv_bits == 4 and head_dim and head_dim % 2:
        raise ValueError(f"kv_bits=4 packs two codes/byte along head_dim; "
                         f"head_dim {head_dim} must be even")


def is_quantized_cache(cache) -> bool:
    """Whether a (paged) cache dict holds k-quantile codes, not dense KV."""
    return isinstance(cache, dict) and "k_codes" in cache


def quantize_kv(x: torch.Tensor, kv_bits: int, use_kernel: bool = True):
    """Code a block of KV rows:  x (..., KV, hd) -> (codes, mu, sigma).

    codes : (..., KV, hd) int8 for kv_bits=8, (..., KV, hd//2) uint8 packed
            for kv_bits=4 (int8 codes carry the k=256 storage offset).
    mu/sigma : (..., KV) bf16 per-(row, head) statistics (population
            deviation); codes are computed against the bf16-rounded values.
    ``use_kernel=False`` is the comparison hook: the plain version
    (``kquantile.kv_codes``) on whatever device the tensors are on.
    """
    if not use_kernel:
        return kq.kv_codes(x, kv_bits)
    xf = x.to(torch.float32)
    mu, sigma = kq.kv_row_stats(xf)
    stored = kops.quantize_weights(
        xf, mu.to(torch.float32)[..., None],
        sigma.to(torch.float32)[..., None], bits=kv_bits)
    return stored, mu, sigma


def dequantize_kv(stored: torch.Tensor, mu: torch.Tensor,
                  sigma: torch.Tensor, kv_bits: int,
                  dtype=torch.float32, use_kernel: bool = True) -> torch.Tensor:
    """codes (+ per-row stats) -> dense KV rows via the analytic levels."""
    return kops.dequantize_weights(
        stored, mu.to(torch.float32)[..., None],
        sigma.to(torch.float32)[..., None], bits=kv_bits, out_dtype=dtype,
        use_kernel=use_kernel)


def fake_quant_kv(x: torch.Tensor, kv_bits: int, use_kernel: bool = True):
    """Round-trip a KV block; returns (x_dq, codes, mu, sigma)."""
    stored, mu, sigma = quantize_kv(x, kv_bits, use_kernel)
    return dequantize_kv(stored, mu, sigma, kv_bits, x.dtype,
                         use_kernel), stored, mu, sigma


def append_kv(pool_layer_view, pages, rows, k: torch.Tensor, v: torch.Tensor,
              kv_bits: int, use_kernel: bool = True) -> None:
    """Code fresh K/V rows (..., KV, hd) and write codes and statistics into
    one layer of a coded pool at (pages, rows) (each of k's leading shape),
    in place: ``quantize_kv`` of the rows, then the six index writes.

    ``pool_layer_view`` maps the six leaf names of ``init_paged_cache`` to
    that layer's (P, page, ...) views.  On the card one ``kv_append`` kernel
    launch does all of it; ``use_kernel=False`` is the comparison hook (the
    plain version on whatever device the tensors are on).
    """
    KV, hd = k.shape[-2:]
    args = (pool_layer_view, pages.reshape(-1), rows.reshape(-1),
            k.reshape(-1, KV, hd), v.reshape(-1, KV, hd))
    if use_kernel:
        kq.kv_append(*args, kv_bits=kv_bits)
    else:
        kq.kv_append_plain(*args, kv_bits=kv_bits)


def clone_pages(cache, src, dst):
    """Copy pool pages ``src`` onto ``dst`` across every cache leaf, in
    place (the copy-on-write primitive behind prefix sharing).

    ``src``/``dst`` are (N,) page ids into the pool axis (axis 1 of each
    (L, P, page, ...) leaf); (0, 0) sink self-copies are harmless padding.
    """
    for leaf in cache.values():
        src_t = torch.as_tensor(src, dtype=torch.long, device=leaf.device)
        dst_t = torch.as_tensor(dst, dtype=torch.long, device=leaf.device)
        leaf[:, dst_t] = leaf[:, src_t]
    return cache


def page_fingerprint(cache, page: int) -> str:
    """Host-side content hash of one pool page across all layers/leaves."""
    h = hashlib.sha256()
    for name in sorted(cache):
        h.update(name.encode())
        leaf = cache[name][:, page].detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.int16)
        h.update(np.ascontiguousarray(leaf.numpy()).tobytes())
    return h.hexdigest()


def token_kv_bytes(cfg, kv_bits: int, dense_itemsize: int = 2) -> int:
    """Exact KV-pool bytes one token occupies across all layers."""
    check_kv_bits(kv_bits, cfg.head_dim)
    hd = cfg.head_dim
    if kv_bits == 16:
        per_head = dense_itemsize * hd
    elif kv_bits == 8:
        per_head = hd + 2 * STATS_BYTES
    else:
        per_head = hd // 2 + 2 * STATS_BYTES
    return 2 * cfg.n_layers * cfg.n_kv_heads * per_head     # K and V


def page_kv_bytes(cfg, page_size: int, kv_bits: int,
                  dense_itemsize: int = 2) -> int:
    """Pool bytes of one page (the scheduler's allocation unit)."""
    return page_size * token_kv_bytes(cfg, kv_bits, dense_itemsize)
