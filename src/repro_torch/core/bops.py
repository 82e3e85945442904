"""BOPs (bit-operations) complexity accounting — paper Sec. 4.2.

For a conv layer with n input channels, m output channels, k x k filters,
b_w-bit weights and b_a-bit activations over an H x W output map:

    accumulator width  b_o  = b_a + b_w + log2(n k^2)
    BOPs               ~ H W m n k^2 (b_a b_w + b_a + b_w + log2(n k^2))

(the paper quotes the per-output-pixel form; we multiply by the output map).
A linear layer is the k=1 case with H=W=1 and n=in_features, m=out_features.
Memory-fetch cost: each parameter fetched once from external memory at b BOPs
per bit -> n_params * b_w  (+ activations are *not* counted as fetches, per
the paper's two assumptions).

These formulas reproduce Table 1's methodology and extend it to the assigned
transformer/SSM/MoE architectures (per-token BOPs).

Pure arithmetic: the port keeps its own copy of the reference's
``core/bops.py``; ``lm_bops`` takes the port's ``configs.base.ArchConfig``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


@dataclasses.dataclass
class LayerBops:
    name: str
    macs: float          # multiply-accumulates
    n_params: float
    fan_in: float        # n * k^2 for the accumulator-width term
    b_w: int
    b_a: int

    @property
    def bops(self) -> float:
        bo_extra = math.log2(max(self.fan_in, 2.0))
        return self.macs * (self.b_w * self.b_a + self.b_w + self.b_a
                            + bo_extra)

    @property
    def fetch_bops(self) -> float:
        return self.n_params * self.b_w

    @property
    def weight_bits(self) -> float:
        return self.n_params * self.b_w


def conv_bops(name: str, h: int, w: int, cin: int, cout: int, ksize: int,
              b_w: int, b_a: int, groups: int = 1) -> LayerBops:
    macs = h * w * cout * (cin // groups) * ksize * ksize
    n_params = cout * (cin // groups) * ksize * ksize
    return LayerBops(name, macs, n_params, (cin // groups) * ksize * ksize,
                     b_w, b_a)


def linear_bops(name: str, n_in: int, n_out: int, b_w: int, b_a: int,
                tokens: int = 1) -> LayerBops:
    macs = tokens * n_in * n_out
    return LayerBops(name, macs, n_in * n_out, n_in, b_w, b_a)


@dataclasses.dataclass
class ModelBops:
    layers: List[LayerBops]

    @property
    def total_bops(self) -> float:
        return sum(l.bops for l in self.layers) + sum(
            l.fetch_bops for l in self.layers)

    @property
    def compute_bops(self) -> float:
        return sum(l.bops for l in self.layers)

    @property
    def model_size_bits(self) -> float:
        return sum(l.weight_bits for l in self.layers)

    @property
    def model_size_mbit(self) -> float:
        return self.model_size_bits / 1e6

    @property
    def gbops(self) -> float:
        return self.total_bops / 1e9

    def table_row(self) -> Tuple[float, float]:
        return self.model_size_mbit, self.gbops


# --------------------------------------------------------------------------
# Paper's own architectures (for Table 1 cross-checking)
# --------------------------------------------------------------------------

def resnet18_imagenet(b_w: int, b_a: int,
                      quantize_first_last: bool = True) -> ModelBops:
    """ResNet-18 @ 224x224, BasicBlock x [2,2,2,2]."""
    L: List[LayerBops] = []
    bw0 = b_w if quantize_first_last else 32
    ba0 = b_a if quantize_first_last else 32
    L.append(conv_bops("conv1", 112, 112, 3, 64, 7, bw0, ba0))
    spec = [(64, 64, 56), (64, 128, 28), (128, 256, 14), (256, 512, 7)]
    for idx, (cin, cout, hw) in enumerate(spec):
        # block 1 (possibly strided/downsample)
        L.append(conv_bops(f"l{idx}b0c0", hw, hw, cin, cout, 3, b_w, b_a))
        L.append(conv_bops(f"l{idx}b0c1", hw, hw, cout, cout, 3, b_w, b_a))
        if cin != cout:
            L.append(conv_bops(f"l{idx}b0ds", hw, hw, cin, cout, 1, b_w, b_a))
        # block 2
        L.append(conv_bops(f"l{idx}b1c0", hw, hw, cout, cout, 3, b_w, b_a))
        L.append(conv_bops(f"l{idx}b1c1", hw, hw, cout, cout, 3, b_w, b_a))
    L.append(linear_bops("fc", 512, 1000, bw0, ba0))
    return ModelBops(L)


def mobilenet_v1_imagenet(b_w: int, b_a: int,
                          quantize_first_last: bool = True) -> ModelBops:
    """MobileNet-V1 @ 224x224 (depthwise-separable stack)."""
    L: List[LayerBops] = []
    bw0 = b_w if quantize_first_last else 32
    ba0 = b_a if quantize_first_last else 32
    L.append(conv_bops("conv1", 112, 112, 3, 32, 3, bw0, ba0))
    # (cin, cout, hw_out, stride applied before) standard MobileNet-V1 spec
    spec = [(32, 64, 112), (64, 128, 56), (128, 128, 56), (128, 256, 28),
            (256, 256, 28), (256, 512, 14)] + [(512, 512, 14)] * 5 + \
           [(512, 1024, 7), (1024, 1024, 7)]
    for i, (cin, cout, hw) in enumerate(spec):
        L.append(conv_bops(f"dw{i}", hw, hw, cin, cin, 3, b_w, b_a,
                           groups=cin))
        L.append(conv_bops(f"pw{i}", hw, hw, cin, cout, 1, b_w, b_a))
    L.append(linear_bops("fc", 1024, 1000, bw0, ba0))
    return ModelBops(L)


# --------------------------------------------------------------------------
# Transformer-family per-token BOPs (assigned architectures)
# --------------------------------------------------------------------------

def lm_bops(cfg, b_w: int, b_a: int, tokens: int = 1) -> ModelBops:
    """Per-``tokens`` BOPs of an LM config (weight-bearing matmuls only).

    ``cfg`` is a ``repro_torch.configs.base.ArchConfig``.  MoE counts only
    active experts (top-k), matching the 6*N_active*D convention.
    """
    L: List[LayerBops] = []
    d = cfg.d_model
    L.append(linear_bops("embed", cfg.vocab, d, b_w, b_a, 0))  # lookup: fetch only
    L[-1].macs = 0.0
    for i in range(cfg.n_layers):
        hd = cfg.head_dim
        L.append(linear_bops(f"l{i}.q", d, cfg.n_heads * hd, b_w, b_a, tokens))
        L.append(linear_bops(f"l{i}.k", d, cfg.n_kv_heads * hd, b_w, b_a, tokens))
        L.append(linear_bops(f"l{i}.v", d, cfg.n_kv_heads * hd, b_w, b_a, tokens))
        L.append(linear_bops(f"l{i}.o", cfg.n_heads * hd, d, b_w, b_a, tokens))
        if cfg.n_experts > 1:
            k_act = cfg.top_k
            L.append(linear_bops(f"l{i}.router", d, cfg.n_experts, 32, b_a,
                                 tokens))
            for j in range(3):  # gate/up/down SwiGLU
                lb = linear_bops(f"l{i}.e{j}", d, cfg.d_ff, b_w, b_a,
                                 tokens * k_act)
                lb.n_params = cfg.n_experts * d * cfg.d_ff  # storage: all experts
                L.append(lb)
        elif cfg.d_ff > 0:
            L.append(linear_bops(f"l{i}.ff_gate", d, cfg.d_ff, b_w, b_a, tokens))
            L.append(linear_bops(f"l{i}.ff_up", d, cfg.d_ff, b_w, b_a, tokens))
            L.append(linear_bops(f"l{i}.ff_down", cfg.d_ff, d, b_w, b_a, tokens))
    L.append(linear_bops("lm_head", d, cfg.vocab, b_w, b_a, tokens))
    return ModelBops(L)
