"""Mamba-2 SSD (state-space duality) blocks: the chunked prefill scan and the
O(1)-state decode step.

Per layer (n_groups = 1, following the Mamba-2 reference dims):

    in_proj : d -> [z (d_in), x (d_in), B (n), C (n), dt (nh)]
    conv1d  : causal depthwise width-4 over [x, B, C] channels, SiLU
    SSD     : h_t = exp(dt_t A)_h * h_{t-1} + dt_t * B_t x_t^T
              y_t = C_t . h_t + D_h x_t
    gate    : y = RMSNorm(y * silu(z))
    out_proj: d_in -> d

with d_in = expand * d, heads nh = d_in / headdim.  Both projections go
through ``lm.mm``: a k-quantile-coded weight is multiplied by the
dequant-fused ``qmatmul`` / ``qmatmul_lut`` kernel on the card (its plain
version on the CPU, or with ``use_kernels=False``).  The scan, the
convolution and the gated norm are plain PyTorch, as they are plain jnp in
the reference.

The chunked scan (a loop over S/Q chunks) computes the intra-chunk part as
a masked (Q, Q) product and carries the (nh, hd, n) state across chunks:
the SSD block decomposition of arXiv:2405.21060.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.lm import mm


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int     # expand * d_model
    n_heads: int     # d_inner // headdim
    headdim: int
    state: int       # n
    d_conv: int = 4

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.state

    @property
    def in_proj_out(self) -> int:
        # z, x, B, C, dt
        return 2 * self.d_inner + 2 * self.state + self.n_heads


def _split_in_proj(proj: torch.Tensor, dims: SSMDims):
    """(..., in_proj_out) -> z (d_inner), xbc (conv_channels), dt (nh)."""
    return torch.split(proj, [dims.d_inner, dims.conv_channels,
                              dims.n_heads], dim=-1)


def _split_xbc(xbc: torch.Tensor, dims: SSMDims):
    """(..., conv_channels) -> x (d_inner), B (n), C (n)."""
    return torch.split(xbc, [dims.d_inner, dims.state, dims.state], dim=-1)


def causal_conv1d(xbc: torch.Tensor, conv_w: torch.Tensor,
                  conv_b: torch.Tensor) -> torch.Tensor:
    """(B, S, C) depthwise causal convolution of width d_conv; conv_w
    (C, d_conv), a cross-correlation as XLA's (tap j meets position
    t - (d_conv - 1) + j).  Computed in f32 on the left-padded input, the
    d_conv taps summed in order as ``mamba2_decode`` sums its window (no
    cuDNN call, whose TF32 switch would otherwise set the precision on the
    card), and cast back to xbc's dtype."""
    S = xbc.shape[1]
    d_conv = conv_w.shape[-1]
    x = F.pad(xbc.to(torch.float32), (0, 0, d_conv - 1, 0))
    w = conv_w.to(torch.float32)
    out = x[:, 0:S] * w[:, 0]
    for j in range(1, d_conv):
        out = out + x[:, j:j + S] * w[:, j]
    return (out + conv_b.to(torch.float32)).to(xbc.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             chunk: int = 128):
    """Chunked SSD.

    x  : (B, S, nh, hd)   inputs per head
    dt : (B, S, nh)       softplus'd step sizes
    A_log : (nh,)         A = -exp(A_log)
    Bm, Cm : (B, S, n)    input / output projections (shared across heads)
    D  : (nh,)            skip
    returns y (B, S, nh, hd) in x's dtype, final state (B, nh, hd, n) f32.

    When ``chunk`` does not divide S the whole sequence is one chunk (the
    reference's rule, which sets the summation order): its (B, S, S, nh)
    f32 decay tensor then grows with S^2 (4.3 GB at B 4, S 2048, nh 64).
    ``serve.generate`` steps its prompt through ``ssd_decode_step``; only
    ``model.prefill`` reaches this.
    """
    Bsz, S, nh, hd = x.shape
    n = Bm.shape[-1]
    if S % chunk:
        chunk = S
    nc = S // chunk

    A = -torch.exp(A_log.to(torch.float32))                 # (nh,) negative
    dtf = dt.to(torch.float32)
    la = dtf * A                                            # log-decay
    xc = x.reshape(Bsz, nc, chunk, nh, hd)
    dtc = dtf.reshape(Bsz, nc, chunk, nh)
    lac = la.reshape(Bsz, nc, chunk, nh)
    Bc = Bm.reshape(Bsz, nc, chunk, n).to(torch.float32)
    Cc = Cm.reshape(Bsz, nc, chunk, n).to(torch.float32)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    h = torch.zeros((Bsz, nh, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xb = xc[:, c].to(torch.float32)
        dtb, Bb, Cb = dtc[:, c], Bc[:, c], Cc[:, c]
        # cumulative log-decay within the chunk (inclusive)
        cs = torch.cumsum(lac[:, c], dim=1)                 # (B, Q, nh)
        # intra-chunk: scores[i,j] = (C_i.B_j) exp(cs_i - cs_j) dt_j, j<=i
        cb = torch.einsum("bin,bjn->bij", Cb, Bb)           # (B, Q, Q)
        # exp(cs_i - cs_j) for j > i is a growth factor that may overflow,
        # and the backward of a product with inf is NaN even where it is
        # masked: mask the exponent before the exp (the kept triangle is
        # the same f32 operations), then select the product
        seg = torch.where(mask, cs[:, :, None] - cs[:, None, :], zero)
        sc = cb[..., None] * torch.exp(seg) * dtb[:, None]  # (B, Q, Q, nh)
        sc = torch.where(mask, sc, zero)
        y_intra = torch.einsum("bijh,bjhd->bihd", sc, xb)
        # inter-chunk: y_i += C_i . h_prev * exp(cs_i)
        y_inter = torch.einsum("bin,bhdn,bih->bihd", Cb, h, torch.exp(cs))
        # state: h = exp(cs_Q) h + sum_j exp(cs_Q - cs_j) dt_j B_j x_j^T
        tot = cs[:, -1]                                     # (B, nh)
        w = torch.exp(tot[:, None] - cs) * dtb              # (B, Q, nh)
        dh = torch.einsum("bjh,bjn,bjhd->bhdn", w, Bb, xb)
        h = torch.exp(tot)[..., None, None] * h + dh
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, nh, hd)
    y = y + x * D.to(x.dtype)[None, None, :, None]
    return y, h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                    h: torch.Tensor):
    """One-token SSD update.

    x (B, nh, hd), dt (B, nh), Bm / Cm (B, n), h (B, nh, hd, n) f32.
    Returns y (B, nh, hd) in x's dtype and the new h.
    """
    A = -torch.exp(A_log.to(torch.float32))
    dtf = dt.to(torch.float32)
    a = torch.exp(dtf * A)                                  # (B, nh)
    xf = x.to(torch.float32)
    dh = torch.einsum("bh,bn,bhd->bhdn", dtf, Bm.to(torch.float32), xf)
    h = a[..., None, None] * h + dh
    y = torch.einsum("bn,bhdn->bhd", Cm.to(torch.float32), h)
    y = y + xf * D.to(torch.float32)[None, :, None]
    return y.to(x.dtype), h


def _gate_out(y: torch.Tensor, z: torch.Tensor, p: dict,
              use_kernels: bool) -> torch.Tensor:
    """RMSNorm(y * silu(z)) (the default eps 1e-6, as the reference: not
    ``cfg.norm_eps``), then out_proj."""
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    return mm(y, p["out_proj"], use_kernels)


def _softplus_dt(dt: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt.to(torch.float32) + dt_bias.to(torch.float32))


def mamba2_block(x: torch.Tensor, p: dict, dims: SSMDims, chunk: int = 128,
                 state_out: bool = False, use_kernels: bool = True):
    """The Mamba-2 block on (B, S, d); ``p`` holds this layer's parameters
    (``in_proj`` / ``out_proj`` dense or coded).  ``state_out`` also
    returns the decode cache: the *pre-conv* window xbc[:, S-(d_conv-1):]
    and the final SSM state."""
    B, S, _ = x.shape
    proj = mm(x, p["in_proj"], use_kernels)
    z, xbc_raw, dt = _split_in_proj(proj, dims)
    xbc = F.silu(causal_conv1d(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = _split_xbc(xbc, dims)
    dt = _softplus_dt(dt, p["dt_bias"])
    xh = xs.reshape(B, S, dims.n_heads, dims.headdim)
    y, hT = ssd_scan(xh, dt, p["A_log"], Bm, Cm, p["D"], chunk=chunk)
    out = _gate_out(y.reshape(B, S, dims.d_inner), z, p, use_kernels)
    if state_out:
        return out, xbc_raw[:, S - (dims.d_conv - 1):], hT
    return out


def mamba2_decode(x: torch.Tensor, p: dict, dims: SSMDims,
                  conv_cache: torch.Tensor, ssm_state: torch.Tensor,
                  use_kernels: bool = True):
    """One-token Mamba-2 step.

    x (B, 1, d); conv_cache (B, d_conv-1, conv_channels); ssm_state
    (B, nh, hd, n) f32.  Returns (y (B, 1, d), new conv window, new state);
    the caches passed in are not written.
    """
    B = x.shape[0]
    proj = mm(x[:, 0], p["in_proj"], use_kernels)           # (B, proj)
    z, xbc, dt = _split_in_proj(proj, dims)
    # rolling window = [cache, current]
    win = torch.cat([conv_cache, xbc[:, None]], dim=1)      # (B, d_conv, C)
    conv = (win.to(torch.float32) * p["conv_w"].to(torch.float32).T).sum(1)
    conv = conv + p["conv_b"].to(torch.float32)
    xbc = F.silu(conv).to(x.dtype)
    xs, Bm, Cm = _split_xbc(xbc, dims)
    dt = _softplus_dt(dt, p["dt_bias"])
    y, ssm_state = ssd_decode_step(
        xs.reshape(B, dims.n_heads, dims.headdim), dt, p["A_log"], Bm, Cm,
        p["D"], ssm_state)
    out = _gate_out(y.reshape(B, dims.d_inner), z, p, use_kernels)
    return out[:, None], win[:, 1:], ssm_state
