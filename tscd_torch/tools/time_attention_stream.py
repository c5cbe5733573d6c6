"""Times the fused attention's streaming route on the card at the port's
self-attention shapes: q = k = 960 at d 64 (the online MSA's fg guidance)
and d 32, 8000 at d 32, 16000 at d 64 and 32 (h 4, B 1, 20% of the keys
invalid, seeded random q/k/v). Each time is the mean of back-to-back calls
of the wrapper between CUDA events, after two warm-up calls.

    python -m tscd_torch.tools.time_attention_stream

prints one JSON line: the checkout, the card's name and power limit, and
ms a call at each shape. It calls only `fused_dual_attention`, which every
version of the port has, so to compare two versions on one card, run this
file from both checkouts in turns (A B B A), each with its own package
first on the path:

    (cd other_checkout && PYTHONPATH=. python3 /path/to/time_attention_stream.py)
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (q = k, head dim, fg guidance, timed calls)
SHAPES = ((960, 64, True, 50), (960, 32, True, 50), (8000, 32, False, 5),
          (16000, 64, False, 3), (16000, 32, False, 3))


def main() -> int:
    if not torch.cuda.is_available():
        print("time_attention_stream times the card only: no CUDA device", file=sys.stderr)
        return 2
    from tscd_torch.ops.kernels import fused_attention as fa
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    rec = {"checkout": str(Path(fa.__file__).resolve().parents[3]),
           "card": card.strip().splitlines()[0] if card.strip() else None}
    for n, d, fg, reps in SHAPES:
        def mk(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
        qkv = [mk(1, 4, n, d) for _ in range(6)]
        score = torch.from_numpy(rng.uniform(0, 1, (1, n)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.uniform(size=(1, n)) < 0.8).to(dev)
        fgs = (torch.from_numpy(rng.uniform(0.05, 1, (1, n)).astype(np.float32)).to(dev)
               if fg else None)

        def call():
            return fa.fused_dual_attention(*qkv, score, valid, 25.0, fgs)
        call()
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        rec[f"q{n}_d{d}{'_fg' if fg else ''}_ms"] = start.elapsed_time(end) / reps
        del qkv
        torch.cuda.empty_cache()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
