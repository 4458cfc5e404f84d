"""Peak device memory and step time of `HybridParallelTrainer` with remat
at GPT-2-small width: (data, seq, model) = (1, 2, 2) over 4 shards of
card 0, bf16 compute with float32 masters, Adam with ZeRO-1, batch 8 x
1024 tokens, 12 layers unless told otherwise, random weights from seed 0.

    python tools/torch_mesh_remat_memory.py [--root DIR] [--layers 12]
        [--steps 3]

`--root` names the checkout whose `deeplearning4j_tpu_torch` is measured
(default: the one this file is in), so that two trees compare in one
call on one card.  After one warm-up step the peak counter is reset,
`--steps` steps run, and one JSON line is printed: the card's name and
power limit, the bytes allocated before the steps, the peak allocated
during them, the mean step ms (host clock around a synchronised step),
the losses, and the flash launches a step (B2 `flash_forward`, B3
`flash_bwd_dkv`, B4 `flash_bwd_dq`).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.parallel import kernels as fk
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import HybridParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(tfm.gpt2_small(max_len=1024),
                              n_layers=args.layers)
    mesh = make_mesh((1, 2, 2), ("data", "seq", "model"),
                     devices=[torch.device("cuda", 0)] * 4)
    tr = HybridParallelTrainer(cfg, mesh, lr=3e-4, updater="adam",
                               params=tfm.numpy_params(cfg, seed=0))
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (8, 1025))
    tokens, targets = tok[:, :-1], tok[:, 1:]
    tr.fit_batch(tokens, targets)                    # builds the kernels
    torch.cuda.synchronize()
    counters = {"flash_fwd": fk.flash_forward.launches,
                "flash_bwd_dkv": fk.flash_bwd_dkv.launches,
                "flash_bwd_dq": fk.flash_bwd_dq.launches}
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    losses, ms = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(float(tr.fit_batch(tokens, targets)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(json.dumps({
        "root": os.path.abspath(args.root), "card": card[0] if card else None,
        "layers": args.layers, "mesh": [1, 2, 2], "batch": [8, 1024],
        "start_bytes": start, "peak_bytes": peak,
        "peak_above_start_bytes": peak - start,
        "step_ms": ms, "step_ms_mean": float(np.mean(ms)), "losses": losses,
        "launches_a_step": {n: c.value // args.steps
                            for n, c in counters.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
