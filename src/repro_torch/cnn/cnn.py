"""CNN substrate of the paper's own experiments: narrow ResNet-18 and a
small MobileNet-V1-style net on 32x32 images (the paper's CIFAR-10
protocol, App. A: a "narrow version of ResNet-18").

The parameter tree is the reference's exactly: a flat dict (in the
reference's insertion order), conv kernels HWIO ``(kh, kw, cin, cout)``
(depthwise ``(3, 3, 1, cin)``), the fc matrix ``(cin, n_classes)``, norms
``{"scale", "bias"}``.  So a reference tree converts by numpy alone, and
the on-chip UNIQ draw is defined on the reference's element order.
Activations are NHWC at every public function, as in the reference.

Convolutions go to ``F.conv2d`` on NCHW-contiguous inputs: the NHWC
activations between layers are views of NCHW tensors, so only the input
image is copied (a channels-last input is avoided: torch's CPU convolution
backward aborts on one in torch 2.13); the HWIO kernel is permuted to OIHW
at the call.  ``"SAME"`` padding is JAX's: ``pad_total = max((ceil(H / s) - 1)
s + kh - H, 0)``, the smaller half before -- so at stride 2 on an even
input a 3x3 conv pads (0, 1), not (1, 1).  GroupNorm is
``F.group_norm`` (contiguous channel groups, biased variance, as the
reference's).  Parameters are drawn on the CPU from a ``torch.Generator``
seeded with ``seed`` (other bits than ``jax.random``; the same
distributions) and moved to ``device``.

``layer_names(params)`` orders the weight-bearing layers front to back, so
the gradual schedule's blocks follow the paper's "one layer per stage"
strategy (Fig. B.1).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.devices import resolve_device


def conv_init(gen: torch.Generator, shape) -> torch.Tensor:
    """He-scaled truncated normal (in [-2, 2] standard deviations) of an
    HWIO kernel, f32 on the CPU."""
    fan_in = shape[0] * shape[1] * shape[2]
    std = (2.0 / fan_in) ** 0.5
    t = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           groups: int = 1) -> torch.Tensor:
    """NHWC x, HWIO w, JAX "SAME" padding -> NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[1], kh, stride)
    left, right = _same_pad(x.shape[2], kw, stride)
    xc = x.permute(0, 3, 1, 2).contiguous()
    if top or bottom or left or right:
        xc = F.pad(xc, (left, right, top, bottom))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC x: ``g = min(groups, C)`` lowered until it
    divides C, contiguous channel groups, biased variance, f32."""
    C = x.shape[-1]
    g = min(groups, C)
    while C % g:
        g -= 1
    y = F.group_norm(x.permute(0, 3, 1, 2).to(torch.float32), g, scale,
                     bias, eps)
    return y.permute(0, 2, 3, 1)


def _norm(c: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((c,), dtype=torch.float32),
            "bias": torch.zeros((c,), dtype=torch.float32)}


def _fc(gen: torch.Generator, cin: int, n_classes: int) -> torch.Tensor:
    return torch.randn((cin, n_classes), generator=gen,
                       dtype=torch.float32) * (1.0 / cin) ** 0.5


def _to(p: Dict[str, Any], device) -> Dict[str, Any]:
    dev = resolve_device(device)
    return {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                else v.to(dev)) for k, v in p.items()}


# --------------------------------------------------------------------------
# narrow ResNet-18 (paper App. A)
# --------------------------------------------------------------------------

RESNET_STAGES = (1, 2, 4, 8)


def init_resnet18(seed: int, width: int = 16, n_classes: int = 10,
                  device="cuda") -> Dict[str, Any]:
    """BasicBlock x [2, 2, 2, 2]; width 16 = 'narrow' (64 = standard)."""
    gen = torch.Generator().manual_seed(int(seed))
    p: Dict[str, Any] = {}
    p["conv1"] = conv_init(gen, (3, 3, 3, width))
    p["norm1"] = _norm(width)
    cin = width
    for stage, mult in enumerate(RESNET_STAGES):
        cout = width * mult
        for blk in range(2):
            pre = f"s{stage}b{blk}"
            p[f"{pre}_conv0"] = conv_init(gen, (3, 3, cin, cout))
            p[f"{pre}_norm0"] = _norm(cout)
            p[f"{pre}_conv1"] = conv_init(gen, (3, 3, cout, cout))
            p[f"{pre}_norm1"] = _norm(cout)
            if cin != cout:
                p[f"{pre}_down"] = conv_init(gen, (1, 1, cin, cout))
            cin = cout
    p["fc"] = _fc(gen, cin, n_classes)
    p["fc_bias"] = torch.zeros((n_classes,), dtype=torch.float32)
    return _to(p, device)


def resnet18_apply(p: Dict[str, Any], x: torch.Tensor,
                   width: int = 16) -> torch.Tensor:
    """Logits (B, n_classes) of NHWC images x."""
    x = conv2d(x, p["conv1"])
    x = F.relu(group_norm(x, **p["norm1"]))
    for stage in range(len(RESNET_STAGES)):
        stride = 1 if stage == 0 else 2
        for blk in range(2):
            pre = f"s{stage}b{blk}"
            s = stride if blk == 0 else 1
            h = conv2d(x, p[f"{pre}_conv0"], stride=s)
            h = F.relu(group_norm(h, **p[f"{pre}_norm0"]))
            h = conv2d(h, p[f"{pre}_conv1"])
            h = group_norm(h, **p[f"{pre}_norm1"])
            if f"{pre}_down" in p:
                x = conv2d(x, p[f"{pre}_down"], stride=s)
            x = F.relu(x + h)
    x = torch.mean(x, dim=(1, 2))
    return x @ p["fc"] + p["fc_bias"]


# --------------------------------------------------------------------------
# small MobileNet-V1 (depthwise separable)
# --------------------------------------------------------------------------

# (channel multiplier of the pointwise output, depthwise stride)
MOBILENET_SPEC = [(1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1), (8, 1)]


def init_mobilenet(seed: int, width: int = 16, n_classes: int = 10,
                   device="cuda") -> Dict[str, Any]:
    gen = torch.Generator().manual_seed(int(seed))
    p: Dict[str, Any] = {}
    p["conv1"] = conv_init(gen, (3, 3, 3, width))
    p["norm1"] = _norm(width)
    cin = width
    for i, (mult, _stride) in enumerate(MOBILENET_SPEC):
        cout = width * mult
        p[f"dw{i}"] = conv_init(gen, (3, 3, 1, cin))
        p[f"dw{i}_norm"] = _norm(cin)
        p[f"pw{i}"] = conv_init(gen, (1, 1, cin, cout))
        p[f"pw{i}_norm"] = _norm(cout)
        cin = cout
    p["fc"] = _fc(gen, cin, n_classes)
    p["fc_bias"] = torch.zeros((n_classes,), dtype=torch.float32)
    return _to(p, device)


def mobilenet_apply(p: Dict[str, Any], x: torch.Tensor,
                    width: int = 16) -> torch.Tensor:
    x = F.relu(group_norm(conv2d(x, p["conv1"], stride=1), **p["norm1"]))
    cin = width
    for i, (mult, stride) in enumerate(MOBILENET_SPEC):
        x = conv2d(x, p[f"dw{i}"], stride=stride, groups=cin)
        x = F.relu(group_norm(x, **p[f"dw{i}_norm"]))
        x = conv2d(x, p[f"pw{i}"])
        x = F.relu(group_norm(x, **p[f"pw{i}_norm"]))
        cin = width * mult
    x = torch.mean(x, dim=(1, 2))
    return x @ p["fc"] + p["fc_bias"]


def layer_names(p: Dict[str, Any]) -> List[str]:
    """Weight-bearing layer paths, front to back (the tree's own order),
    for the gradual blocks."""
    return [k for k in p
            if not k.endswith(("_norm", "_bias")) and "norm" not in k]


def cnn_quant_filter(path: str, leaf) -> bool:
    """UNIQ filter for the CNN trees: convs and fc, not norms or biases.
    The paper quantizes the first and last layers too (conv1 and fc)."""
    if leaf.ndim < 2:
        return False
    return "norm" not in path


def n_quantized(p: Dict[str, Any]) -> int:
    """Number of weights the UNIQ transform passes over."""
    return sum(math.prod(p[name].shape) for name in layer_names(p))
