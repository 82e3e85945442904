"""UNIQ QAT training loop of the paper's CNN experiments (Tables 2, 3, A.1,
B.1).

``run_experiment`` trains a narrow ResNet-18 / small MobileNet on the
synthetic 10-class image stream with the chosen quantizer under the
noise-injection scheme, then evaluates with deterministically quantized
weights (the inference-time model), as the reference does:

  * gradual stages (one block per layer by default; FROZEN layers are
    hard-quantized and optimizer-masked, the active block gets uniform noise
    in u-space, later blocks are CLEAN), over ``iterations`` passes;
  * first and last layers quantized;
  * logits fake-quantized to ``a_bits`` (straight-through);
  * AdamW (weight decay 1e-4, clip 1.0), lr decayed as
    ``lr * 0.5 ** (3 * step / steps)``; optional fp pre-training steps.

Noise: the k-quantile QAT step draws it inside the ``uniq_noise_fwd_onchip``
kernel on the card, keyed per leaf by (seed, step, leaf path)
(``core/uniq.py:onchip_noise``); on the CPU the plain version draws the
same bits, so a step on the card and on the CPU see the same noise.  The
gradient goes through the ``uniq_noise_bwd`` kernel.  ``qat_step`` takes
another noise source too (a test hands in the reference's own draw as a
``NoiseFn``).  The bits differ from the reference's ``jax.random`` stream;
the distribution is the same.

The state is updated in place (``optim.apply_updates``).

    python -m repro_torch.cnn.train [--model resnet18|mobilenet]
        [--device cuda|cpu] [--steps 400] [--width 8] [--w-bits 4]
        [--a-bits 8] [--method kquantile|uniform|kmeans]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.cnn import cnn
from repro_torch.core.activations import fake_quant_act
from repro_torch.core.uniq import (FROZEN, GradualSchedule, UniqConfig,
                                   onchip_noise, transform_tree)
from repro_torch.data.synthetic import ImageStreamConfig, image_batch
from repro_torch.devices import resolve_device
from repro_torch.optim import optim as optim_lib


@dataclasses.dataclass
class CNNExperiment:
    model: str = "resnet18"        # resnet18 | mobilenet
    width: int = 16
    w_bits: int = 4
    a_bits: int = 32
    method: str = "kquantile"      # kquantile | uniform | kmeans
    steps: int = 300
    batch: int = 128
    lr: float = 3e-3
    noise: float = 1.2             # image noise (task difficulty)
    n_stages: int = 0              # gradual blocks; 0 = one per layer
    iterations: int = 2
    finetune_from: Optional[Dict] = None   # pre-trained params
    pretrain_steps: int = 0        # plain FP steps before QAT (fine-tune)
    seed: int = 0
    device: str = "cuda"


def _apply_fn(exp: CNNExperiment) -> Callable:
    if exp.model == "resnet18":
        return lambda p, x: cnn.resnet18_apply(p, x, width=exp.width)
    return lambda p, x: cnn.mobilenet_apply(p, x, width=exp.width)


def _init_fn(exp: CNNExperiment, device) -> Dict[str, Any]:
    if exp.model == "resnet18":
        return cnn.init_resnet18(exp.seed, width=exp.width, device=device)
    return cnn.init_mobilenet(exp.seed, width=exp.width, device=device)


def _mode_fn(layer_order: List[str], modes):
    idx = {name: i for i, name in enumerate(layer_order)}

    def mode_for(path):
        return modes[idx.get(path.split("/")[0], len(layer_order) - 1)]
    return mode_for


def _loss(apply_fn, params, images, labels, a_bits):
    logits = apply_fn(params, images)
    if a_bits < 32:
        logits = fake_quant_act(logits, a_bits)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


@torch.no_grad()
def accuracy(apply_fn, params, dcfg: ImageStreamConfig, n_batches: int = 8,
             start: int = 10_000, device="cuda") -> float:
    correct = total = 0
    for i in range(n_batches):
        images, labels = image_batch(dcfg, start + i, device=device)
        pred = torch.argmax(apply_fn(params, images), dim=-1)
        correct += int((pred == labels).sum())
        total += labels.shape[0]
    return correct / total


def _clone(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A copy of a parameter tree on ``device``, in its own key order (the
    order ``layer_names`` reads)."""
    return {k: _clone(v, device) if isinstance(v, dict)
            else v.detach().to(device).clone() for k, v in tree.items()}


def _lr(exp: CNNExperiment, step: int) -> torch.Tensor:
    return torch.tensor(exp.lr * (0.5 ** (step / max(exp.steps, 1) * 3)),
                        dtype=torch.float32)


class CNNTrainer:
    """The state of one experiment (``params``, ``opt_state``) and its steps;
    ``run_experiment`` drives it, ``chip_smoke.py`` steps it one by one."""

    def __init__(self, exp: CNNExperiment):
        self.exp = exp
        self.device = resolve_device(exp.device)
        self.apply_fn = _apply_fn(exp)
        self.params = (_clone(exp.finetune_from, self.device)
                       if exp.finetune_from else _init_fn(exp, self.device))
        self.layer_order = cnn.layer_names(self.params)
        n_layers = len(self.layer_order)
        self.ucfg = UniqConfig(w_bits=exp.w_bits, a_bits=exp.a_bits,
                               method=exp.method)
        self.schedule = GradualSchedule(n_layers=n_layers,
                                        n_blocks=exp.n_stages or n_layers,
                                        total_steps=exp.steps,
                                        iterations=exp.iterations)
        self.ocfg = optim_lib.OptimConfig(kind="adamw", lr=exp.lr,
                                          weight_decay=1e-4, grad_clip=1.0)
        self.opt_state = optim_lib.init_state(self.params, self.ocfg)
        self.dcfg = ImageStreamConfig(batch=exp.batch, noise=exp.noise,
                                      seed=1)

    @property
    def quant_on(self) -> bool:
        return self.exp.w_bits < 32

    def loss_and_grads(self, images, labels, modes=None, noise=None,
                       use_kernel: bool = True):
        """(loss, grads): at the UNIQ-transformed parameters for per-layer
        ``modes`` (host int32) and the ``noise`` source, or at the
        parameters as they are (the fp step) when ``modes`` is None."""
        flat = list(tree_lib.leaves_with_paths(self.params))
        with torch.enable_grad():
            req = {p: t.detach().requires_grad_(True) for p, t in flat}
            p_in = tree_lib.map_with_path(lambda p, _t: req[p], self.params)
            a_bits = 32
            if modes is not None:
                mode_for = _mode_fn(self.layer_order, modes)
                p_in = transform_tree(p_in, noise, mode_for, self.ucfg,
                                      quant_filter=cnn.cnn_quant_filter,
                                      stacked_prefixes=(),
                                      use_kernel=use_kernel)
                a_bits = self.exp.a_bits
            loss = _loss(self.apply_fn, p_in, images, labels, a_bits)
            grads = torch.autograd.grad(loss, [req[p] for p, _ in flat],
                                        allow_unused=True)
        by_path = {p: torch.zeros_like(t) if g is None else g
                   for (p, t), g in zip(flat, grads)}
        return loss.detach(), tree_lib.map_with_path(
            lambda p, _t: by_path[p], self.params)

    def freeze_mask(self, modes) -> Dict[str, Any]:
        """Per-leaf 0/1 mask: quantized leaves of FROZEN layers stop."""
        mode_for = _mode_fn(self.layer_order, modes)

        def one(p, leaf):
            if cnn.cnn_quant_filter(p, leaf):
                m = (mode_for(p) != FROZEN).to(torch.float32)
            else:
                m = torch.ones((), dtype=torch.float32)
            return m.to(leaf.device)
        return tree_lib.map_with_path(one, self.params)

    def fp_step(self, images, labels, lr) -> torch.Tensor:
        loss, grads = self.loss_and_grads(images, labels)
        optim_lib.apply_updates(self.params, grads, self.opt_state,
                                self.ocfg, lr)
        return loss

    def qat_step(self, images, labels, modes, noise, lr,
                 use_kernel: bool = True) -> torch.Tensor:
        loss, grads = self.loss_and_grads(images, labels, modes, noise,
                                          use_kernel)
        optim_lib.apply_updates(self.params, grads, self.opt_state,
                                self.ocfg, lr,
                                freeze_mask=self.freeze_mask(modes))
        return loss

    def step(self, i: int) -> torch.Tensor:
        """Global step ``i`` of the run: fp pre-training steps first, then
        ``exp.steps`` QAT (or fp, at w_bits >= 32) steps."""
        exp = self.exp
        images, labels = image_batch(self.dcfg, i, device=self.device)
        if i < exp.pretrain_steps:
            return self.fp_step(images, labels,
                                torch.tensor(exp.lr, dtype=torch.float32))
        step = i - exp.pretrain_steps
        lr = _lr(exp, step)
        if not self.quant_on:
            return self.fp_step(images, labels, lr)
        return self.qat_step(images, labels, self.schedule.modes_at(step),
                             onchip_noise(exp.seed, step), lr)

    @torch.no_grad()
    def quantized_params(self, use_kernel: bool = True) -> Dict[str, Any]:
        """The inference-time model: every quantized weight FROZEN
        (deterministic k-quantile, or the ablation quantizer)."""
        if not self.quant_on:
            return self.params
        return transform_tree(self.params, onchip_noise(0, 0), FROZEN,
                              self.ucfg, quant_filter=cnn.cnn_quant_filter,
                              stacked_prefixes=(), use_kernel=use_kernel)

    def accuracy(self, params) -> float:
        return accuracy(self.apply_fn, params, self.dcfg,
                        device=self.device)


def run_experiment(exp: CNNExperiment) -> Dict[str, Any]:
    trainer = CNNTrainer(exp)
    t0 = time.time()
    loss = torch.zeros(())
    for i in range(exp.pretrain_steps + exp.steps):
        loss = trainer.step(i)
    final_loss = float(loss)
    train_time = time.time() - t0
    params_q = trainer.quantized_params()
    return {"accuracy": trainer.accuracy(params_q),
            "train_time_s": train_time, "final_loss": final_loss,
            "params": trainer.params, "params_quantized": params_q}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("resnet18", "mobilenet"),
                   default="resnet18")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--width", type=int, default=8)
    p.add_argument("--w-bits", type=int, default=4)
    p.add_argument("--a-bits", type=int, default=8)
    p.add_argument("--method", choices=("kquantile", "uniform", "kmeans"),
                   default="kquantile")
    return p.parse_args(argv)


def main(argv=None):
    """The paper's experiment: UNIQ gradual quantization (4 blocks) against
    the full-precision baseline (half the steps) on the synthetic CIFAR
    stand-in; prints the reference example's three lines."""
    args = parse_args(argv)
    base = dict(model=args.model, width=args.width, batch=64,
                lr=3e-3, noise=1.5, seed=0, device=args.device)
    fp = run_experiment(CNNExperiment(w_bits=32, steps=args.steps // 2,
                                      **base))
    print(f"fp32 baseline     : acc={fp['accuracy']:.3f} "
          f"({fp['train_time_s']:.0f}s)")
    q = run_experiment(CNNExperiment(
        w_bits=args.w_bits, a_bits=args.a_bits, method=args.method,
        n_stages=4, steps=args.steps, **base))
    print(f"UNIQ w{args.w_bits}a{args.a_bits} (gradual): "
          f"acc={q['accuracy']:.3f} ({q['train_time_s']:.0f}s)")
    print(f"accuracy gap: {fp['accuracy'] - q['accuracy']:.3f} "
          f"(paper: ~0 at w4a8 on ImageNet)")
    return fp, q


if __name__ == "__main__":
    main()
