"""The multi-device dry run and its evidence log (counterpart of
`deeplearning4j_tpu.dryrun` and of the JAX package's
``dryrun_multichip``).

One training step of each parallel layout on tiny shapes, over a mesh of
``n_devices`` entries of one device (the card; with ``--device cpu``,
host shards), as the JAX package runs it on its virtual CPU devices:

1. dp        — LeNet-5 through `DataParallelTrainer`
2. dp+zero1  — the same with the ZeRO-1 weight update
3. dp/sp/tp/ep — the TransformerLM on a (data, seq, model) mesh: ring
                 attention over ``seq``, heads and experts over ``model``
4. dp/pp     — the TransformerLM's blocks over ``stage``, GPipe
               microbatches, a tied LM head

The run writes a timestamped log (its output, the git SHA, the host and
the wall time) to ``--out`` (default ``<repo>/EVIDENCE``) as
``dryrun_YYYYMMDD_HHMM.log``, and prints ``dryrun GREEN`` or ``dryrun
FAILED``.

Usage::

    python -m deeplearning4j_tpu_torch.dryrun [n_devices] [--out DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import pathlib
import platform
import subprocess
import sys
import time
import traceback
from contextlib import redirect_stderr, redirect_stdout

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent


def _lenet_conf(updater: str = "adam"):
    from deeplearning4j_tpu_torch.models.zoo import lenet_mnist

    return lenet_mnist(updater=updater)


def _split_axes(n: int, parts: int):
    """Factor n into `parts` axis sizes, largest factors last (e.g.
    8,3 -> (2,2,2); 4,3 -> (1,2,2); 6,2 -> (2,3))."""
    shape = []
    for i in range(parts, 1, -1):
        target = round(n ** (1.0 / i)) or 1
        f = 1
        for c in range(target, 0, -1):
            if n % c == 0:
                f = c
                break
        shape.append(f)
        n //= f
    shape.append(n)
    return tuple(sorted(shape))


def _check_finite(what: str, loss: float) -> None:
    if not np.isfinite(loss):
        raise RuntimeError(f"{what} loss not finite: {loss}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full training step of each layout above over a mesh of
    `n_devices` entries of `device` (the card by default), each loss
    checked finite."""
    import torch

    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        DataParallelTrainer,
        make_mesh,
    )
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        HybridParallelTrainer,
        PipelineParallelTrainer,
    )

    dev = resolve_device(device)
    devices = [dev] * n_devices
    rng = np.random.default_rng(0)

    # 1. data-parallel LeNet
    mesh = make_mesh((n_devices,), ("data",), devices=devices)
    net = MultiLayerNetwork(_lenet_conf(), device=dev).init()
    trainer = DataParallelTrainer(net, mesh=mesh)
    batch = 2 * n_devices
    x = rng.random((batch, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    loss = trainer.fit_batch(x, y)
    _check_finite("dp", loss)
    print(f"dryrun dp({n_devices}): ok, loss={loss:.4f}, "
          f"{trainer.scaling_report()}")

    # 2. dp with the ZeRO-1 weight update
    net_z = MultiLayerNetwork(_lenet_conf(), device=dev).init()
    zero = DataParallelTrainer(net_z, mesh=mesh, shard_update=True)
    loss = zero.fit_batch(x, y)
    _check_finite("dp+zero", loss)
    print(f"dryrun dp({n_devices})+zero1: ok, loss={loss:.4f}")

    # 3. dp x sp x tp (+ep) TransformerLM; the head count a multiple of
    # tp and d_model of the head count, so every tp factor splits
    dp, sp, tp = _split_axes(n_devices, 3)
    mesh3 = make_mesh((dp, sp, tp), ("data", "seq", "model"),
                      devices=devices)
    n_heads = 4 * tp
    cfg = tfm.TransformerConfig(
        vocab_size=64, d_model=4 * n_heads, n_heads=n_heads, n_layers=2,
        d_ff=8 * n_heads, n_experts=2 * tp, moe_top_k=2, max_len=64)
    hybrid = HybridParallelTrainer(cfg, mesh3, lr=0.05)
    b, s = 2 * dp, 4 * sp
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    targets = rng.integers(0, cfg.vocab_size, (b, s))
    loss = hybrid.fit_batch(tokens, targets)
    _check_finite("hybrid", loss)
    print(f"dryrun dp/sp/tp/ep mesh=({dp},{sp},{tp}): ok, loss={loss:.4f}")

    # 4. dp x pp TransformerLM, tied LM head
    dp2, pp = _split_axes(n_devices, 2)
    mesh2 = make_mesh((dp2, pp), ("data", "stage"), devices=devices)
    cfg2 = tfm.TransformerConfig(
        vocab_size=64, d_model=16, n_heads=4, n_layers=pp, d_ff=32,
        max_len=64, tie_embeddings=True)
    m = 2
    pipe = PipelineParallelTrainer(cfg2, mesh2, n_microbatches=m, lr=0.05)
    b2 = dp2 * m * 2
    tokens = rng.integers(0, cfg2.vocab_size, (b2, 8))
    targets = rng.integers(0, cfg2.vocab_size, (b2, 8))
    loss = pipe.fit_batch(tokens, targets)
    _check_finite("pipeline", loss)
    print(f"dryrun dp/pp mesh=({dp2},{pp}) microbatches={m}: ok, "
          f"loss={loss:.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _git(*args: str) -> str:
    try:
        out = subprocess.run(["git", *args], cwd=REPO, capture_output=True,
                             text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def _host_lines(device: str) -> list:
    import torch

    lines = [f"python: {sys.version.split()[0]} ({platform.platform()})",
             f"torch: {torch.__version__}, CUDA {torch.version.cuda}"]
    if device != "cpu" and torch.cuda.is_available():
        lines.append(f"device: {torch.cuda.get_device_name(0)}")
    else:
        lines.append("device: cpu")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.dryrun",
        description="Run the multi-device dry run and write an evidence "
                    "log.")
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--out", default=str(REPO / "EVIDENCE"),
                    help="evidence directory (default: <repo>/EVIDENCE)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    sha = _git("rev-parse", "HEAD") or "unknown"
    status = _git("status", "--porcelain")
    dirty = "dirty" if status else ("clean" if sha != "unknown"
                                    else "unknown")
    t0 = time.time()
    buf = io.StringIO()
    ok, err = True, None
    try:
        with redirect_stdout(buf), redirect_stderr(buf):
            dryrun_multichip(args.n_devices, args.device)
    except Exception as e:  # noqa: BLE001 - a failed run is evidence too
        ok, err = False, f"{type(e).__name__}: {e}"
        traceback.print_exc(file=buf)
    wall = time.time() - t0

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M", time.gmtime())
    path = out_dir / f"dryrun_{ts}.log"
    header = [
        "# multichip dryrun evidence — "
        f"{time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())}",
        f"git_sha: {sha} ({dirty})",
        f"n_devices: {args.n_devices}",
        f"result: {'GREEN' if ok else f'FAILED ({err})'}",
        f"wall_time_s: {wall:.1f}",
        "command: python -m deeplearning4j_tpu_torch.dryrun "
        f"{args.n_devices}" + (f" --device {args.device}"
                               if args.device else ""),
        *_host_lines(args.device or "cuda"),
        "--- run output ---",
    ]
    path.write_text("\n".join(header) + "\n" + buf.getvalue())
    sys.stdout.write(buf.getvalue())
    print(("dryrun GREEN" if ok else f"dryrun FAILED: {err}")
          + f" in {wall:.1f} s -> {path}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
