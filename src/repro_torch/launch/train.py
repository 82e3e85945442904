"""Training driver: UNIQ QAT with checkpoint/restart fault tolerance.

Usage (the smoke size on the CPU; without ``--device cpu`` it runs on the
card and raises where there is none):

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_8b \\
        --smoke --device cpu --steps 4

Every family trains: dense, the MoE kimi_k2 / llama4 (cross-entropy alone,
as the reference's), the state-space mamba2 / zamba2, the audio whisper
(zero stub frames, as many as tokens) and the vlm pixtral (zero patch
embeddings ahead of the tokens), as the reference's trainer feeds them.

Fault tolerance: periodic atomic checkpoints (params + optimizer + step) in
the reference's layout; on start, the trainer resumes from LATEST if
present.  The data stream and the noise are keyed by (seed, step), so the
replay is exact.  A step-time watchdog logs straggler steps (>
``--straggler-factor`` x the running median).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import base as cb
from repro_torch.core.uniq import UniqConfig
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.devices import resolve_device
from repro_torch.models.lm import ModelOpts
from repro_torch.optim.optim import OptimConfig
from repro_torch.train import steps as train_steps


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--w-bits", type=int, default=4)
    p.add_argument("--a-bits", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optim", default="adamw", choices=["sgd", "adamw"])
    p.add_argument("--n-blocks", type=int, default=0)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--straggler-factor", type=float, default=3.0)
    p.add_argument("--data-mesh", type=int, default=1,
                   help="parsed and not read, as in the reference's "
                        "trainer: this CLI trains one process, whatever "
                        "the value (data parallelism over ranks is the "
                        "library's: launch/mesh.py, "
                        "TrainConfig.dp_compress_bits)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def setup(args: argparse.Namespace):
    """(arch config, model options, train config) of a parsed command
    line."""
    cfg = cb.get_smoke(args.arch) if args.smoke else cb.get(args.arch)
    opts = ModelOpts(compute_dtype=torch.float32, remat=False,
                     attn_chunked_min_len=1 << 30, ce_chunk=512,
                     ssd_chunk=16)
    tc = train_steps.TrainConfig(
        uniq=UniqConfig(w_bits=args.w_bits, a_bits=args.a_bits),
        optim=OptimConfig(kind=args.optim, lr=args.lr, weight_decay=1e-4),
        total_steps=args.steps, n_blocks=args.n_blocks)
    return cfg, opts, tc


def train_batch(cfg: cb.ArchConfig, dcfg: LMStreamConfig, step: int,
                device):
    """Step ``step``'s batch: ``lm_batch``'s tokens / targets (B, S), and
    the zero f32 inputs the reference's trainer puts beside them: at the
    vlm family ``patch_embeds`` (B, n_patches, d), at audio ``frames``
    (B, S, d)."""
    batch = lm_batch(dcfg, step, device=device)
    B, S = batch["tokens"].shape
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (B, cfg.n_patches, cfg.d_model), dtype=torch.float32,
            device=device)
    elif cfg.family == "audio":
        batch["frames"] = torch.zeros((B, S, cfg.d_model),
                                      dtype=torch.float32, device=device)
    return batch


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, opts, tc = setup(args)
    step_fn, _ = train_steps.make_train_step(cfg, opts, tc)

    state = train_steps.init_state(args.seed, cfg, tc, device=dev)
    start_step = 0
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        state, start_step, _ = ckpt_lib.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start_step}")

    dcfg = LMStreamConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.batch, seed=args.seed)
    times = []
    metrics = None
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = train_batch(cfg, dcfg, step, dev)
        state, metrics = step_fn(state, batch, args.seed)
        loss = float(metrics["loss"])            # waits for the step
        dt = time.perf_counter() - t0
        times.append(dt)
        med = float(np.median(times[-50:]))
        if dt > args.straggler_factor * med and len(times) > 10:
            print(f"[watchdog] step {step} straggled: {dt:.2f}s vs median "
                  f"{med:.2f}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, state,
                          extra={"arch": args.arch})
            ckpt_lib.prune_old(args.ckpt_dir, keep=3)
    if args.ckpt_dir:
        ckpt_lib.save(args.ckpt_dir, args.steps, state,
                      extra={"arch": args.arch})
    if metrics is not None:
        print(f"[train] done; final loss {float(metrics['loss']):.4f}")
    return state


if __name__ == "__main__":
    main()
