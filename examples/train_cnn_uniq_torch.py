"""End-to-end driver on the PyTorch / CUDA port: the paper's own
experiment — narrow ResNet-18 with UNIQ gradual quantization (k-quantile,
4-bit weights, 8-bit activations) vs the full-precision baseline, on the
synthetic CIFAR stand-in.

    PYTHONPATH=src python examples/train_cnn_uniq_torch.py [--steps 400]
    PYTHONPATH=src python examples/train_cnn_uniq_torch.py --device cpu \
        --steps 8 --width 4
"""

import argparse

from repro_torch.cnn.train import CNNExperiment, run_experiment


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--width", type=int, default=8)
    p.add_argument("--w-bits", type=int, default=4)
    p.add_argument("--a-bits", type=int, default=8)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    # every draw (weights, data, noise) comes from generators seeded by
    # ``seed`` inside the trainer
    base = dict(model="resnet18", width=args.width, batch=args.batch,
                lr=3e-3, noise=1.5, seed=args.seed, device=args.device)
    fp = run_experiment(CNNExperiment(w_bits=32, steps=args.steps // 2,
                                      **base))
    print(f"fp32 baseline     : acc={fp['accuracy']:.3f} "
          f"({fp['train_time_s']:.0f}s)")
    q = run_experiment(CNNExperiment(
        w_bits=args.w_bits, a_bits=args.a_bits, n_stages=4,
        steps=args.steps, **base))
    print(f"UNIQ w{args.w_bits}a{args.a_bits} (gradual): "
          f"acc={q['accuracy']:.3f} ({q['train_time_s']:.0f}s)")
    print(f"accuracy gap: {fp['accuracy'] - q['accuracy']:.3f} "
          f"(paper: ~0 at w4a8 on ImageNet)")


if __name__ == "__main__":
    main()
