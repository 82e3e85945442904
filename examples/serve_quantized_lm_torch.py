"""Serving example on the PyTorch / CUDA port: batched generation from a
W4-quantized LM, comparing greedy outputs and weight memory against the
f32 model.

    PYTHONPATH=src python examples/serve_quantized_lm_torch.py --arch yi_6b
    PYTHONPATH=src python examples/serve_quantized_lm_torch.py --device cpu
"""

import argparse

import torch

from repro_torch import tree
from repro_torch.configs import base as cb
from repro_torch.devices import resolve_device
from repro_torch.models import model
from repro_torch.models.lm import ModelOpts
from repro_torch.serve import serve as serve_lib


def serve_both(params, cfg, prompts, w_bits, new_tokens, device):
    """Greedy generation from ``params`` and from their ``w_bits`` copy:
    (dense tokens, quantized tokens, f32 bytes, quantized bytes)."""
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, ssd_chunk=16)
    sc = serve_lib.ServeConfig(w_bits=w_bits)
    out_fp = serve_lib.generate(params, cfg, opts, sc, prompts, new_tokens)
    params_q = serve_lib.prepare_params(params, sc, device=device)
    out_q = serve_lib.generate(params_q, cfg, opts, sc, prompts, new_tokens)
    bytes_fp = sum(x.numel() * 4 for x in tree.leaves(params))
    bytes_q = sum(x.numel() * x.element_size()
                  for x in tree.leaves(params_q))
    return out_fp, out_q, bytes_fp, bytes_q


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi_6b")
    p.add_argument("--w-bits", type=int, default=4)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--new-tokens", type=int, default=24)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)

    cfg = cb.get_smoke(args.arch)
    params = model.init(args.seed, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, 8), generator=gen,
                            device=dev)
    out_fp, out_q, bytes_fp, bytes_q = serve_both(
        params, cfg, prompts, args.w_bits, args.new_tokens, dev)
    match = float((out_fp == out_q).float().mean())
    print(f"arch={cfg.name}  W{args.w_bits} weights: "
          f"{bytes_fp / 1e6:.1f} MB -> {bytes_q / 1e6:.1f} MB "
          f"({bytes_fp / bytes_q:.1f}x)")
    print(f"greedy agreement with fp32 over {args.new_tokens} tokens: "
          f"{match * 100:.1f}%")
    print("fp32:", out_fp[0].tolist())
    print(f"W{args.w_bits} :", out_q[0].tolist())


if __name__ == "__main__":
    main()
