"""Quickstart on the PyTorch / CUDA port: UNIQ in 60 lines.

1. quantize a weight matrix with the k-quantile quantizer (uniformization
   trick), 2. train a tiny LM with uniform-noise-injection QAT, 3. serve it
   with packed int4 weights (the ``qmatmul`` kernel on the card).

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch import tree
from repro_torch.configs import base as cb
from repro_torch.core.distributions import GaussianModel
from repro_torch.core.quantizers import (kquantile_dequantize,
                                         kquantile_quantize)
from repro_torch.core.uniq import UniqConfig
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.models.lm import ModelOpts
from repro_torch.optim.optim import OptimConfig
from repro_torch.train import steps as train_steps


def kquantile_demo(w):
    """Step 1: 4-bit k-quantile codes of ``w`` under its fitted Gaussian and
    their analytic dequantization: (relative error, bins used)."""
    m = GaussianModel.fit(w)
    codes = kquantile_quantize(w, m, k=16)                 # 4-bit codes
    w_hat = kquantile_dequantize(codes, m, k=16)           # analytic dequant
    rel = float(torch.linalg.norm(w - w_hat) / torch.linalg.norm(w))
    return rel, len(torch.unique(codes))


def serving_demo(params, cfg, opts, toks, device):
    """Step 3: the last-position greedy tokens of ``params`` and of their
    packed int4 copy on ``toks``: (agreement, f32 bytes, int4 bytes)."""
    params_q = model.quantize_for_serving(params, bits=4, device=device)
    with torch.no_grad():
        logits_fp, _ = model.prefill(params, cfg, opts, {"tokens": toks})
        logits_q, _ = model.prefill(params_q, cfg, opts, {"tokens": toks})
    agree = float((logits_fp.argmax(-1) == logits_q.argmax(-1)).float()
                  .mean())
    n_fp = sum(x.numel() * 4 for x in tree.leaves(params))
    n_q = sum(x.numel() * x.element_size() for x in tree.leaves(params_q))
    return agree, n_fp, n_q


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    # --- 1. the k-quantile quantizer on a bell-shaped tensor ---------------
    w = torch.randn((256, 256), generator=gen, device=dev) * 0.02
    rel, bins = kquantile_demo(w)
    print(f"[1] 4-bit k-quantile: rel err {rel:.3f}, bins used {bins}/16")

    # --- 2. noise-injection QAT on a tiny LM --------------------------------
    cfg = cb.get_smoke("granite_3_8b")
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, ce_chunk=64)
    tc = train_steps.TrainConfig(
        uniq=UniqConfig(w_bits=4, a_bits=8),
        optim=OptimConfig(kind="adamw", lr=2e-3),
        total_steps=args.steps, n_blocks=2)
    step_fn, _schedule = train_steps.make_train_step(cfg, opts, tc)
    state = train_steps.init_state(args.seed, cfg, tc, device=dev)
    data = LMStreamConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                          seed=args.seed)
    # the noise of step s is keyed by (noise_seed, s)
    noise_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                   device=dev))
    first = last = None
    for step in range(tc.total_steps):
        state, metrics = step_fn(state, lm_batch(data, step, device=dev),
                                 noise_seed)
        last = float(metrics["loss"])
        first = last if first is None else first
    print(f"[2] UNIQ QAT (w4a8, gradual): loss {first:.3f} -> {last:.3f}")

    # --- 3. quantized serving ------------------------------------------------
    toks = lm_batch(data, 999, device=dev)["tokens"][:2, :16]
    agree, n_fp, n_q = serving_demo(state["params"], cfg, opts, toks, dev)
    print(f"[3] int4 serving: greedy agreement {agree * 100:.0f}%, "
          f"weights {n_fp / 1e6:.1f} MB -> {n_q / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
