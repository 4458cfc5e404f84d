"""What is live at the peak of one `HybridParallelTrainer` step with
remat, by the code that allocated it: the setting of
`tools/torch_mesh_remat_memory.py` ((data, seq, model) = (1, 2, 2) over 4
shards of card 0, `gpt2_small` width, bf16 compute, f32 masters, Adam,
batch 8 x 1024, 12 layers unless told otherwise, seed 0).

    python tools/torch_mesh_remat_peak.py [--root DIR] [--layers 12]

`--root` names the checkout whose `deeplearning4j_tpu_torch` is measured
(default: the one this file is in).  After one warm-up step, one step
runs under the CUDA caching allocator's history
(`torch.cuda.memory._record_memory_history`); the events are replayed
to find the moment the bytes allocated during the step peak, and the
blocks live then are grouped by the innermost frame of the package's
code (else the first C++ frame of an autograd or ATen function).
Prints one JSON line (the card, the peak above the bytes allocated
before the step, the event at the peak), then one line a group: MB,
blocks, frame.
"""

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np


def _where(event) -> str:
    frames = event.get("frames") or []
    mine = [f for f in frames if "deeplearning4j_tpu_torch" in f["filename"]]
    if mine:
        f = mine[0]
        return f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}"
    cpp = [f["name"] for f in frames
           if "autograd::generated" in f["name"] or "native::" in f["name"]]
    return ("C++ " + cpp[0][:100]) if cpp else "?"


def _live_at_peak(events) -> tuple:
    """(bytes at the peak, the index of the event that reached it, the
    alloc events live then)."""
    sizes, total, best, at = {}, 0, -1, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            sizes[e["addr"]] = e["size"]
            total += e["size"]
        elif e["action"] == "free_completed":
            total -= sizes.pop(e["addr"], 0)
        if total > best:
            best, at = total, i
    live = {}
    for e in events[:at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_completed":
            live.pop(e["addr"], None)
    return best, at, list(live.values())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import HybridParallelTrainer
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    cfg = dataclasses.replace(tfm.gpt2_small(max_len=1024),
                              n_layers=args.layers)
    mesh = make_mesh((1, 2, 2), ("data", "seq", "model"),
                     devices=[torch.device("cuda", 0)] * 4)
    tr = HybridParallelTrainer(cfg, mesh, lr=3e-4, updater="adam",
                               params=tfm.numpy_params(cfg, seed=0))
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 1025))
    tokens, targets = tok[:, :-1], tok[:, 1:]
    tr.fit_batch(tokens, targets)                    # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="all")
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    tr.fit_batch(tokens, targets)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][0]
    best, at, live = _live_at_peak(events)
    groups, blocks = collections.Counter(), collections.Counter()
    for e in live:
        groups[_where(e)] += e["size"]
        blocks[_where(e)] += 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(json.dumps({
        "root": os.path.abspath(args.root), "card": card[0] if card else None,
        "layers": args.layers, "start_bytes": start,
        "peak_above_start_bytes": peak - start,
        "live_at_peak_bytes": best, "peak_event": _where(events[at])}))
    for name, size in groups.most_common(20):
        print(f"{size / 1e6:10.1f} MB {blocks[name]:5d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
