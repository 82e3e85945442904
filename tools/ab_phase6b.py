"""A/B of the host-bound trainers of ``chip_smoke.py``'s phase 6b
(mamba2_1_3b, zamba2_2_7b and whisper_base at full width and depth, the
trainer's defaults) between checkouts, on one card.

    python tools/ab_phase6b.py PARENT . . PARENT

runs ``family_train_phase`` of each checkout's own ``chip_smoke.py``
against that checkout's ``src`` (a fresh process each, in the order
given; ``PARENT``: an unpacked older commit, e.g. ``git archive``), then
prints each run's median steps side by side.  The kernels are built once,
into ``REPRO_TORCH_BUILD_DIR`` or else the first checkout's build directory
(they are keyed by their sources' hash).  Each run's own output goes to
``build/ab_phase6b/run_<i>.log``.
"""

import os
import re
import subprocess
import sys

ARCHS = ("mamba2_1_3b", "zamba2_2_7b", "whisper_base")
LOGS = os.path.join("build", "ab_phase6b")
ONE = """
import gc, os, subprocess, sys
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60)
cs.CARD = smi.stdout.strip()
cs.loader.build_all()
for arch in sys.argv[2:]:
    cs.family_train_phase(arch, 0, cs.FAMILY_TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
"""


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    os.makedirs(LOGS, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("REPRO_TORCH_BUILD_DIR", os.path.abspath(
        os.path.join(argv[0], "build", "repro_torch_kernels")))
    rows = []
    for i, root in enumerate(argv, 1):
        log = os.path.join(LOGS, f"run_{i}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "-c", ONE, root, *ARCHS],
                                stdout=f, stderr=subprocess.STDOUT,
                                env=env).returncode
        text = open(log).read()
        if rc:
            print(text[-3000:])
            print(f"run {i} ({root}) failed: rc {rc}")
            return 1
        med = dict(re.findall(r"\[train6b\] (\S+): \d+ steps, median step "
                              r"(\d+) ms", text))
        rows.append((root, [med.get(a, "?") for a in ARCHS]))
        card = re.findall(r"NVIDIA[^;\n]*W", text)
        print(f"run {i} {root}: median step ms "
              + ", ".join(f"{a} {m}" for a, m in zip(ARCHS, rows[-1][1]))
              + f"; {card[-1] if card else 'card unknown'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
