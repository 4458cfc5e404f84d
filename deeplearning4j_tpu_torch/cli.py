"""Command line of the port (subset of `deeplearning4j_tpu.cli`).

    python -m deeplearning4j_tpu_torch.cli train -input data.csv
        -model zoo:iris-mlp|conf.json|<saved dir> [-output dir]
        [-conf props] [-epochs 50] [-batch 32] [-accum 1]
        [-precision fp32|bf16|mixed] [-chunk 1]
        [-metrics-port P] [-metrics-interval 10]
        [-savemode binary|txt] [-device cuda|cpu]
    python -m deeplearning4j_tpu_torch.cli test -input data.csv
        -model <dir>/model
    python -m deeplearning4j_tpu_torch.cli predict -input data.csv
        -model <dir>/model -output preds.txt

trains a `MultiLayerNetwork` on a CSV or SVMLight file with the local
runtime (greedy pretraining first for a ``pretrain`` conf such as
``zoo:dbn-mnist``), saves ``<output>/model`` (`save_model`) and
``params.bin`` / ``params.txt`` (`save_params`), and prints the
examples/sec line and the evaluation (with ``-precision`` the
``precision:`` policy line and the loss-scale summary first; ``-chunk
K`` trains K steps a dispatch through the fused driver; ``-metrics-port``
serves the run's `TrainingTelemetry` at ``GET /metrics``); ``test`` prints
the evaluation of a saved model and ``predict`` writes its argmax
classes one a line.  The JAX package reads every file they write.  Options whose code paths are
not ported exit naming their ROADMAP.md queue.

    python -m deeplearning4j_tpu_torch.cli lm -input <text> [-output dir]
        [-preset gpt2-small] [-seq 128] [-batch 8] [-accum 1] [-epochs 1]
        [-lr 3e-3] [-updater adam] [-experts 0] [-moe-top-k 1]
        [-eval <text>] [-device cuda|cpu]
        [-generate [PROMPT] [-max-new 64] [-temperature 0.8] [-top-k 0]
         [-top-p 1.0] [-gen-seed 0] [-beam 1]]

trains the byte-level TransformerLM on a text file and saves it as
``lm_config.json`` + ``lm_params.npz`` (the JAX package's ``dl4j lm``
layout; either package loads the other's); without ``-input`` it loads
the saved LM.  ``-experts N`` makes every block an MoE of N experts
routing ``-moe-top-k`` a token.  ``-generate`` then decodes from the
prompt (whole-sequence `generate`, or `beam_search` with ``-beam`` > 1)
and prints the text.

    python -m deeplearning4j_tpu_torch.cli serve [-model zoo:<name>|dir|conf]
        [-quantize none|int8] [-buckets 1,8,32] [-max-batch 32]
        [-max-wait-ms 2] [-lm <dir>] [-port 8080] [-lm-slots 4]
        [-lm-kv paged|dense] [-page-size 16] [-lm-pages 0]
        [-prefill-chunk 8] [-lm-speculate off|ngram|model]
        [-lm-draft-len 4] [-lm-ship] [-lm-preempt] [-lm-swap-mb 64]
        [-lm-brownout] [-lm-hibernate-idle-s S] [-lm-disk-dir dir]
        [-lm-disk-mb 1024] [-lm-swap-quantize on|off] [-tenants JSON]
        [-max-queue 256] [-deadline-ms 0] [-breaker-threshold 5]
        [-warmup] [-drain-stats serving_stats.json] [-device cuda|cpu]

serves a classifier and/or a saved LM over HTTP: ``POST /model/predict``
(the `ServingEngine`: requests coalesce within ``-max-wait-ms`` up to
``-max-batch`` rows, padded up the ``-buckets`` ladder; ``-quantize
int8`` serves int8 weights; ``-warmup`` runs every bucket first, for a
dense first layer), ``POST /lm/generate`` (``stream: true`` for SSE;
``/lm/prefill`` and ``/lm/admit_pages`` with ``-lm-ship``), ``GET
/serving/stats``, ``/metrics``, ``/trace/recent``, ``/healthz``,
``/readyz``.  The device defaults to the card; SIGTERM drains in-flight
work, writes the stats snapshot to ``-drain-stats`` and stops.

    python -m deeplearning4j_tpu_torch.cli serve-fleet [-model ...]
        [-lm <dir>] [-replicas 2] [-prefill-workers 0 -decode-workers 0]
        [-disagg-min-prompt 32] [-health-interval-s 1] [-autoscale
        -min-replicas 1 -max-replicas 8] [-drain-stats fleet_stats.json]
        [the classifier and -lm-slots/-page-size/-prefill-chunk/-lm-ship
        flags of serve] [-device cuda|cpu]

serves the same through a fleet of thread-hosted replicas behind a
`FleetRouter` (least-loaded with prefix affinity, failover,
``/readyz`` health ejection, optional autoscale; with
``-prefill-workers`` and ``-decode-workers`` long prompts are prefilled
on one worker and their KV pages shipped to another) and one
`FleetServer` front (``/model/predict``, ``/lm/generate``,
``/fleet/stats``, ``/serving/stats``, ``/metrics``); SIGTERM drains the
whole fleet and writes ``/fleet/stats`` to ``-drain-stats``.
``-processes`` (a process per replica) is not ported (ROADMAP.md, A5
part 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.parallel.transformer import (
    TransformerConfig,
    gpt2_large,
    gpt2_medium,
    gpt2_small,
    params_from_numpy,
)
from deeplearning4j_tpu_torch.runtime.checkpoint import read_lm_npz

PRESETS = {"gpt2-small": gpt2_small, "gpt2-medium": gpt2_medium,
           "gpt2-large": gpt2_large}


def load_saved_lm(out: pathlib.Path, device=None):
    """Load an LM saved by the ``lm`` command of either package -> (cfg,
    params on `device` in the config dtype)."""
    out = pathlib.Path(out)
    cfg_path, params_path = out / "lm_config.json", out / "lm_params.npz"
    if not cfg_path.exists():
        raise SystemExit(f"no saved LM at {out}")
    if not params_path.exists():
        raise SystemExit(f"saved LM incomplete: {params_path} missing")
    cfg = TransformerConfig(**json.loads(cfg_path.read_text()))
    tree = read_lm_npz(params_path, cfg)
    return cfg, params_from_numpy(tree, device=device, dtype=cfg.dtype)


# --------------------------------------------------------------------------
# train / test / predict (reference deeplearning4j-cli Train.java:64)

def load_properties(path: Optional[str]) -> Dict[str, str]:
    """A key=value properties file (the reference's -conf format); ``#``
    starts a comment line."""
    props: Dict[str, str] = {}
    if not path:
        return props
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.partition("=")
        props[key.strip()] = value.strip()
    return props


def _opt_int(v: Optional[str]) -> Optional[int]:
    return int(v) if v else None


def _load_dataset(input_path: str, props: Dict[str, str]):
    """The -input file as a DataSet: ``input.format`` csv or svmlight
    (default: by the file's extension, svmlight unless ``.csv``)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        csv_dataset,
        sniff_svmlight_features,
        svmlight_dataset,
    )

    fmt = props.get("input.format", "").lower() or (
        "csv" if input_path.endswith(".csv") else "svmlight")
    if fmt in ("svmlight", "svm", "libsvm"):
        n_features = int(props.get("input.num.features", 0))
        if not n_features:
            try:
                n_features = sniff_svmlight_features(input_path)
            except ValueError as e:
                raise SystemExit(f"{e} — set input.num.features in the "
                                 f"-conf properties file") from e
        return svmlight_dataset(
            input_path, n_features,
            num_classes=_opt_int(props.get("input.num.classes")))
    if fmt == "csv":
        return csv_dataset(
            input_path, label_col=int(props.get("input.label.column", -1)),
            num_classes=_opt_int(props.get("input.num.classes")),
            skip_header=props.get("input.skip.header", "false") == "true")
    raise SystemExit(f"unknown input.format {fmt!r} (svmlight|csv)")


def _build_net(model_path: str, device):
    """``zoo:<name>`` (a zoo architecture, freshly initialised), a saved
    model directory (`save_model` of either package), or a
    MultiLayerConfiguration JSON file."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, get_model
    from deeplearning4j_tpu_torch.runtime.checkpoint import load_model

    if model_path.startswith("zoo:"):
        return MultiLayerNetwork(get_model(model_path[4:]),
                                 device=device).init()
    p = pathlib.Path(model_path)
    if p.is_dir():
        return load_model(p, device=device)
    return MultiLayerNetwork.from_json(p.read_text(), device=device)


def _refuse_unported_train(args, props: Dict[str, str]) -> None:
    """The `train` options whose code paths are not ported yet."""
    queues = [
        (args.runtime != "local", f"-runtime {args.runtime}",
         "A7, 'Multi-device'"),
        (args.replicas is not None, "-replicas", "A7, 'Multi-device'"),
        (int(props.get("train.sync.every", args.sync_every)) != 1,
         "-sync-every", "A7, 'Multi-device'"),
        (args.resilience or args.resume, "-resilience / -resume",
         "A6, the resilience modules"),
        (any(v is not None for v in (args.ckpt_dir, args.ckpt_every,
                                     args.ckpt_keep)),
         "-ckpt-dir / -ckpt-every / -ckpt-keep", "A6, the resilience "
         "modules"),
    ]
    for refused, flag, queue in queues:
        if refused:
            raise SystemExit(f"{flag}: not ported to PyTorch yet "
                             f"(ROADMAP.md, queue {queue})")


def cmd_train(args) -> int:
    """Train with the local runtime (reference execLocal():151): read the
    records, build the net, greedy-pretrain a fresh ``pretrain`` conf,
    fit `-epochs` passes of shuffled `-batch` batches, save."""
    import torch

    from deeplearning4j_tpu_torch.datasets.iterators import (
        PrefetchDataSetIterator,
    )
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        save_model,
        save_params,
    )
    from deeplearning4j_tpu_torch.runtime.fused import FusedTrainingDriver

    props = load_properties(args.conf)
    _refuse_unported_train(args, props)
    device = resolve_device(args.device)
    ds = _load_dataset(args.input, props)
    net = _build_net(args.model, device)
    epochs = int(props.get("train.epochs", args.epochs))
    batch = int(props.get("train.batch.size", args.batch))
    accum = max(1, int(props.get("train.accum.steps", args.accum)))
    # -metrics-port: a standalone /metrics endpoint for the run, fed by a
    # TrainingTelemetry listener (chunk-aware, synced every
    # -metrics-interval steps)
    telemetry = metrics_srv = None
    if args.metrics_port is not None:
        from deeplearning4j_tpu_torch.obs import (
            MetricsRegistry,
            MetricsServer,
            TrainingTelemetry,
        )

        registry = MetricsRegistry()
        telemetry = TrainingTelemetry(registry=registry,
                                      sync_interval=args.metrics_interval,
                                      batch_size=batch)
        net.add_listener(telemetry)
        metrics_srv = MetricsServer(registry,
                                    port=args.metrics_port).start()
        print(f"train: metrics on {metrics_srv.url}/metrics "
              f"(every {telemetry.sync_interval} steps)", flush=True)

    def batches():
        for epoch in range(epochs):
            yield from ds.shuffle(seed=epoch).batch_by(batch)

    fresh = (args.model.startswith("zoo:")
             or not pathlib.Path(args.model).is_dir())
    if net.conf.pretrain and fresh:
        # greedy layer-wise pretraining for DBN / deep-AE confs; a saved
        # (already trained) model skips it
        net.pretrain(list(ds.shuffle(seed=0).batch_by(batch)), epochs=1)
    precision = props.get("train.precision", args.precision)
    if precision and precision != "fp32":
        # "bf16": bf16 params and compute; "mixed": f32 masters, bf16
        # compute, dynamic loss scaling
        net.set_precision(precision)
        print(f"precision: {net.precision.describe()}")
    chunk = max(1, int(props.get("train.chunk.size", args.chunk)))
    if chunk > 1 and accum > 1:
        print("-accum is ignored with -chunk (a chunk steps over batches)")
        accum = 1
    t0 = time.time()
    if chunk > 1:
        # the fused driver: chunk steps a dispatch, the next chunk staged
        # on the device from a background thread
        FusedTrainingDriver(net, chunk_size=chunk).fit(batches())
    else:
        last = None
        for b in PrefetchDataSetIterator(batches()):
            last = net.fit_batch_async(b.features, b.labels,
                                       accum_steps=accum)
        if last is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
    elapsed = time.time() - t0
    scaler = net.scaler_stats()
    if scaler is not None:
        print(f"precision: loss-scale {scaler['scale']:g}, "
              f"{scaler['overflow_count']} overflow step(s) skipped")
    out = pathlib.Path(args.output or "dl4j-output")
    out.mkdir(parents=True, exist_ok=True)
    save_model(net, out / "model")
    save_params(net, out / ("params.bin" if args.savemode == "binary"
                            else "params.txt"), mode=args.savemode)
    ev = net.evaluate(ds.features, ds.labels)
    total = epochs * ds.num_examples()
    print(f"Trained {epochs} epochs on {ds.num_examples()} examples "
          f"({total / max(elapsed, 1e-9):.1f} examples/sec)")
    print(ev.stats())
    print(f"Model saved to {out / 'model'}")
    if metrics_srv is not None:
        snap = telemetry.snapshot()
        print(f"train: telemetry — {snap['steps']} steps, "
              f"{snap['examples_per_sec']:.1f} examples/sec")
        metrics_srv.stop()
    return 0


def cmd_test(args) -> int:
    props = load_properties(args.conf)
    ds = _load_dataset(args.input, props)
    net = _build_net(args.model, resolve_device(args.device))
    print(net.evaluate(ds.features, ds.labels).stats())
    return 0


def cmd_predict(args) -> int:
    props = load_properties(args.conf)
    ds = _load_dataset(args.input, props)
    net = _build_net(args.model, resolve_device(args.device))
    preds = net.predict(ds.features)
    out = args.output or "predictions.txt"
    np.savetxt(out, preds, fmt="%d")
    print(f"Wrote {len(preds)} predictions to {out}")
    return 0


def _warmup_example(net, cmd: str, warmup: bool):
    """The flat-input warmup rule of the JAX CLI: one zero row of the
    first layer's ``n_in`` features for a dense first layer; for conv or
    recurrent first layers ``n_in`` is channels or per-step features, so
    -warmup is skipped with a note (the first request per bucket runs
    it instead)."""
    from deeplearning4j_tpu_torch.nn.conf import DenseLayerConf

    first = net.conf.layers[0]
    flat = isinstance(first, DenseLayerConf) and first.n_in
    if warmup and not flat:
        print(f"{cmd}: -warmup skipped (non-flat input layer "
              f"{type(first).__name__}); the first request per bucket "
              f"runs it instead")
    return (np.zeros((int(first.n_in),), np.float32) if warmup and flat
            else None)


def _check_lm_flags(args) -> None:
    if args.lm_speculate != "off" and args.lm_kv != "paged":
        raise SystemExit("serve: -lm-speculate requires -lm-kv paged "
                         "(speculative rollback rides the page tables)")
    if args.lm_ship and args.lm_kv != "paged":
        raise SystemExit("serve: -lm-ship requires -lm-kv paged (page "
                         "shipping moves block-table pages)")
    if (args.lm_preempt or args.lm_brownout) and args.lm_kv != "paged":
        raise SystemExit("serve: -lm-preempt/-lm-brownout require -lm-kv "
                         "paged (the overload-survival plane swaps "
                         "block-table pages)")
    if args.lm_hibernate_idle_s is not None and args.lm_kv != "paged":
        raise SystemExit("serve: -lm-hibernate-idle-s requires -lm-kv "
                         "paged (hibernation parks block-table pages)")
    if (args.lm_disk_dir is not None and args.lm_hibernate_idle_s is None
            and not args.lm_preempt):
        raise SystemExit("serve: -lm-disk-dir needs -lm-hibernate-idle-s "
                         "or -lm-preempt (nothing would ever reach the "
                         "disk tier)")


def _serve_lm(srv, args, device, max_queue, deadline_s, breaker_n,
              tenants) -> None:
    """The LM leg of ``serve``: register the saved LM and report it."""
    cfg, params = load_saved_lm(pathlib.Path(args.lm), device=device)
    srv.serve_lm(cfg, params, slots=args.lm_slots,
                 max_queue_depth=max_queue, default_deadline_s=deadline_s,
                 breaker_threshold=breaker_n, tenants=tenants,
                 kv=args.lm_kv, page_size=args.page_size,
                 pages=args.lm_pages if args.lm_pages > 0 else None,
                 prefill_chunk=args.prefill_chunk,
                 speculate=args.lm_speculate, draft_len=args.draft_len,
                 ship=args.lm_ship, preempt=args.lm_preempt,
                 swap_bytes=int(args.lm_swap_mb * (1 << 20)),
                 brownout=args.lm_brownout or None,
                 hibernate_idle_s=args.lm_hibernate_idle_s,
                 state_dir=args.lm_disk_dir,
                 state_disk_bytes=int(args.lm_disk_mb * (1 << 20)),
                 swap_quantize=args.lm_swap_quantize == "on",
                 device=device)
    lm = srv.state.lm_server
    # -warmup runs every dispatch width (and on the card builds the
    # kernel library) before traffic; without it the first requests do
    warmed = lm.warmup() if args.warmup else 0
    warm_note = (f"{warmed} programs warm" if warmed
                 else "programs build on first use")
    if lm.kv == "dense":
        kv_note = f"dense KV: {lm.n_slots} x {cfg.max_len} positions"
    else:
        kv_note = (f"paged KV: {lm.kv_pages} pages x {lm.page_size} "
                   f"tokens, prefill chunk {lm.prefill_chunk}")
        if lm.speculate != "off":
            kv_note += (f", speculate {lm.speculate} (draft_len "
                        f"{lm.draft_len})")
        planes = [name for name, on in (
            ("ship", lm.ship), ("preempt", lm.preempt),
            ("brownout", args.lm_brownout),
            ("hibernate", lm.hibernate)) if on]
        if planes:
            kv_note += ", " + "/".join(planes)
    print(f"serve: LM registered ({cfg.n_layers}L/d{cfg.d_model}, "
          f"max_len {cfg.max_len}, {args.lm_slots} decode slots, "
          f"{kv_note}, {warm_note}, device {device})")


def _wait_for_sigterm(args, cmd: str, drain, snapshot, stop) -> None:
    """Serve until ``-serve-seconds`` pass or SIGTERM; on SIGTERM drain
    (grace ``-drain-grace-s``) and write the stats snapshot to
    ``-drain-stats``; stop either way."""
    term = threading.Event()
    prev = None
    if threading.current_thread() is threading.main_thread():
        prev = signal.signal(signal.SIGTERM, lambda *_: term.set())
    try:
        if args.serve_seconds > 0:
            term.wait(args.serve_seconds)
        else:
            while not term.wait(3600):
                pass
    except KeyboardInterrupt:
        pass
    finally:
        if term.is_set():
            print(f"{cmd}: SIGTERM — draining (grace "
                  f"{args.drain_grace_s}s)", flush=True)
            drained = drain(args.drain_grace_s)
            stats_path = pathlib.Path(args.drain_stats)
            try:
                stats_path.write_text(json.dumps(snapshot(), indent=2))
                where = str(stats_path)
            except OSError as e:
                # a lost snapshot must not leave the server running or
                # the signal handler installed
                where = f"LOST ({e})"
            print(f"{cmd}: drain "
                  f"{'complete' if drained else 'grace expired'}; stats "
                  f"snapshot -> {where}", flush=True)
        stop()
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def cmd_serve(args) -> int:
    from deeplearning4j_tpu_torch.serving.bucketing import BucketLadder
    from deeplearning4j_tpu_torch.ui.server import UiServer

    if not args.model and not args.lm:
        raise SystemExit("serve needs -model and/or -lm")
    if args.lm:
        _check_lm_flags(args)
    max_queue = args.max_queue if args.max_queue > 0 else None
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    breaker_n = (args.breaker_threshold if args.breaker_threshold > 0
                 else None)
    tenants = None
    if args.tenants:
        from deeplearning4j_tpu_torch.serving.tenancy import TenantRegistry

        try:
            tenants = TenantRegistry.from_json(args.tenants)
        except (TypeError, ValueError) as e:
            raise SystemExit(f"serve: -tenants: {e}") from e
    device = resolve_device(args.device)
    srv = UiServer(host=args.host, port=args.port, device=device)
    if args.model:
        net = _build_net(args.model, device)
        ladder = BucketLadder(tuple(
            int(b) for b in args.buckets.split(",")))
        quantize = args.quantize if args.quantize != "none" else None
        srv.serve_model(net, max_batch=min(args.max_batch, ladder.max_batch),
                        max_wait_ms=args.max_wait_ms, ladder=ladder,
                        max_queue_depth=max_queue,
                        default_deadline_s=deadline_s,
                        breaker_threshold=breaker_n, quantize=quantize,
                        tenants=tenants)
        engine = srv.state.engine
        if quantize:
            rep = engine._model().quantization_report()
            ratio = rep["float_param_bytes"] / max(rep["param_bytes"], 1)
            print(f"serve: {quantize} weights — "
                  f"{rep['quantized_layers']}/{rep['total_layers']} layers "
                  f"quantized, {rep['param_bytes']:,} param bytes "
                  f"({ratio:.1f}x smaller than fp32)")
        example = _warmup_example(net, "serve", args.warmup)
        if example is not None:
            print(f"serve: ran {engine.warmup(example)} bucket shapes "
                  f"before traffic")
        print(f"serve: model registered (ladder {list(ladder.batch_buckets)},"
              f" max_batch {engine.batcher.max_batch}, max_wait_ms "
              f"{args.max_wait_ms}, device {net.device})")
    if args.lm:
        _serve_lm(srv, args, device, max_queue, deadline_s, breaker_n,
                  tenants)
    srv.start()
    print(f"serve: resilience max_queue={max_queue or 'unbounded'} "
          f"deadline_ms={args.deadline_ms or 'none'} "
          f"breaker_threshold={breaker_n or 'off'} "
          f"drain_grace_s={args.drain_grace_s}")
    if tenants is not None:
        names = ", ".join(tenants.names())
        print(f"serve: tenancy on — WFQ + token quotas for [{names}] "
              f"(X-Tenant header or 'tenant' field; unknown tenants "
              f"get 400, over-quota gets 429 + Retry-After)")
    print(f"Serving on {srv.url} — POST /model/predict, /lm/generate; "
          f"GET /serving/stats, /metrics, /trace/recent, /healthz, "
          f"/readyz", flush=True)
    _wait_for_sigterm(args, "serve", srv.drain, srv.serving_stats, srv.stop)
    return 0


def cmd_serve_fleet(args) -> int:
    """Serve a classifier and/or a saved LM through a fleet of
    thread-hosted replicas behind a `FleetRouter` and one `FleetServer`
    front; SIGTERM drains the whole fleet and snapshots /fleet/stats."""
    from deeplearning4j_tpu_torch.serving import (
        BucketLadder,
        FleetRouter,
        FleetServer,
        spawn_local_replica,
    )

    if not args.model and not args.lm:
        raise SystemExit("serve-fleet needs -model and/or -lm")
    if args.replicas < 1:
        raise SystemExit(f"-replicas must be >= 1, got {args.replicas}")
    role_split = args.prefill_workers > 0 or args.decode_workers > 0
    if role_split:
        # role scheduling is an LM feature: a classifier-only fleet has
        # nothing to split
        if not args.lm:
            raise SystemExit(
                "serve-fleet: -prefill-workers/-decode-workers need -lm")
        if args.prefill_workers < 1 or args.decode_workers < 1:
            raise SystemExit(
                "serve-fleet: a disaggregated fleet needs BOTH "
                "-prefill-workers >= 1 and -decode-workers >= 1 "
                f"(got {args.prefill_workers}/{args.decode_workers})")
    if args.processes:
        raise SystemExit("serve-fleet -processes: process-per-replica "
                         "fleets are not ported (ROADMAP.md, A5 part 2); "
                         "omit -processes for thread-hosted replicas")
    max_queue = args.max_queue if args.max_queue > 0 else None
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    breaker_n = (args.breaker_threshold if args.breaker_threshold > 0
                 else None)
    quantize = args.quantize if args.quantize != "none" else None
    device = resolve_device(args.device)
    net = _build_net(args.model, device) if args.model else None
    lm_pair = (load_saved_lm(pathlib.Path(args.lm), device=device)
               if args.lm else None)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    warmup_example = (_warmup_example(net, "serve-fleet", args.warmup)
                      if net is not None else None)

    def spawn(name: str, role: str):
        ladder = BucketLadder(buckets)
        return spawn_local_replica(
            name, net, host=args.host, ladder=ladder,
            max_batch=min(args.max_batch, ladder.max_batch),
            max_wait_ms=args.max_wait_ms, warmup_example=warmup_example,
            max_queue_depth=max_queue, default_deadline_s=deadline_s,
            breaker_threshold=breaker_n, quantize=quantize,
            lm=lm_pair, lm_slots=args.lm_slots,
            lm_page_size=args.page_size,
            lm_prefill_chunk=args.prefill_chunk,
            lm_ship=bool(args.lm_ship), role=role, device=device)

    def factory(name: str, role: str = None):
        # autoscale and rolling-swap spawns: a role-aware scale-up names
        # the role pool it grows; unnamed spawns buy decode capacity in
        # a role-split fleet, "both" otherwise
        if role is None:
            role = "decode" if role_split else "both"
        return spawn(name, role)

    router = FleetRouter(
        factory, replicas=0 if role_split else args.replicas,
        min_replicas=min(args.min_replicas, args.replicas),
        max_replicas=max(args.max_replicas, args.replicas),
        health_interval_s=args.health_interval_s,
        disagg_min_prompt=args.disagg_min_prompt)
    if role_split:
        for i in range(args.prefill_workers):
            router.attach(spawn(f"prefill-{i}", "prefill"))
        for i in range(args.decode_workers):
            router.attach(spawn(f"decode-{i}", "decode"))
    router.autoscale = bool(args.autoscale)
    front = FleetServer(router, host=args.host, port=args.port).start()
    router.start_health_loop()
    names = ", ".join(f"{r.name}[{r.role}]" if r.role != "both"
                      else r.name for r in router.replicas())
    print(f"serve-fleet: {len(router.replicas())} warm replicas in "
          f"rotation ({names}); health every {args.health_interval_s}s; "
          f"autoscale {'on' if args.autoscale else 'off'} "
          f"[{router.min_replicas}, {router.max_replicas}]"
          + (f"; disagg: prompts >= {args.disagg_min_prompt} tokens "
             f"split prefill->decode" if role_split else "")
          + f"; device {device}")
    print(f"Serving fleet on {front.url} — POST /model/predict, "
          f"/lm/generate; GET /fleet/stats, /serving/stats, /metrics, "
          f"/trace/recent, /healthz, /readyz", flush=True)
    _wait_for_sigterm(args, "serve-fleet", front.drain, router.fleet_stats,
                      front.stop)
    return 0


def _refuse_unported(args) -> None:
    """The `lm` options whose code paths are not ported yet."""
    if args.runtime != "local":
        raise SystemExit(f"-runtime {args.runtime}: only the local runtime "
                         f"is ported (ROADMAP.md, queue A7, 'Multi-device')")


def _lm_config(args, seq: int) -> TransformerConfig:
    """The `lm` command's model: a preset at byte-level vocab, or the
    -d-model/-layers/-heads model, with float32 parameters; ``-experts``
    makes its blocks MoE."""
    if args.preset:
        cfg = dataclasses.replace(
            PRESETS[args.preset](max_len=seq, dtype="float32"),
            vocab_size=256)
    else:
        cfg = TransformerConfig(vocab_size=256, d_model=args.d_model,
                                n_heads=args.heads, n_layers=args.layers,
                                d_ff=4 * args.d_model, max_len=seq)
    if args.experts:
        cfg = dataclasses.replace(cfg, n_experts=args.experts,
                                  moe_top_k=args.moe_top_k)
    return cfg


def _lm_eval(path: str, cfg: TransformerConfig, params) -> float:
    """Held-out byte-level NLL through `apply`: the mean over at most 64
    non-overlapping `cfg.max_len` windows, 8 windows per batch."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel.transformer import apply

    ev_ids = np.frombuffer(pathlib.Path(path).read_bytes(),
                           np.uint8).astype(np.int64)
    s_ev = cfg.max_len
    if len(ev_ids) < s_ev + 1:
        raise SystemExit(f"-eval file too short for seq_len {s_ev}")
    n_win = min((len(ev_ids) - 1) // s_ev, 64)
    tok = np.stack([ev_ids[i * s_ev:(i + 1) * s_ev] for i in range(n_win)])
    tgt = np.stack([ev_ids[i * s_ev + 1:(i + 1) * s_ev + 1]
                    for i in range(n_win)])
    dev = params["embed"].device
    total = 0.0
    with torch.no_grad():
        for i in range(0, n_win, 8):
            t = torch.from_numpy(tok[i:i + 8]).to(dev)
            g = torch.from_numpy(tgt[i:i + 8]).to(dev)
            logp = F.log_softmax(apply(cfg, params, t, train=False), dim=-1)
            nll = -logp.gather(-1, g[..., None])[..., 0].mean()
            total += len(t) * float(nll)
    nll = total / n_win
    print(f"eval: {n_win} windows x {s_ev} bytes, nll {nll:.4f}, "
          f"perplexity {float(np.exp(nll)):.2f}")
    return nll


def cmd_lm(args) -> int:
    """Train the TransformerLM on a raw text file (byte-level vocab,
    causal LM) and save it, or load a saved one; ``-eval`` then reports
    the held-out perplexity.  The counterpart of the JAX package's
    ``dl4j lm`` with the local runtime: the same config, the same
    batches (numpy ``default_rng(0)``), f32 master parameters with
    bfloat16 compute on the card and float32 on the CPU."""
    import torch

    from deeplearning4j_tpu_torch.parallel.hybrid import (
        _master_f32,
        make_accum_train_step,
    )
    from deeplearning4j_tpu_torch.parallel.transformer import init_params
    from deeplearning4j_tpu_torch.runtime.checkpoint import tree_to_npz

    _refuse_unported(args)
    device = resolve_device(args.device)
    out = pathlib.Path(args.output or "dl4j-lm")
    if not args.input:
        if not (out / "lm_config.json").exists():
            raise SystemExit(f"no -input and no saved LM at {out}")
        cfg, params = load_saved_lm(out, device=device)
    else:
        ids = np.frombuffer(pathlib.Path(args.input).read_bytes(),
                            np.uint8).astype(np.int64)
        S, B = args.seq, args.batch
        if len(ids) < S + 2:
            raise SystemExit(f"input too short for -seq {S}")
        if args.accum > 1 and B % args.accum:
            raise SystemExit(f"-batch {B} must be divisible by -accum "
                             f"{args.accum}")
        cfg = _lm_config(args, S)
        compute_cfg = (dataclasses.replace(cfg, dtype="bfloat16")
                       if device.type == "cuda" else cfg)
        params = _master_f32(init_params(
            cfg, generator=torch.Generator().manual_seed(0), device=device))
        step, init_opt = make_accum_train_step(
            compute_cfg, lr=args.lr, accum=args.accum, updater=args.updater)
        opt_state = init_opt(params)
        rng = np.random.default_rng(0)
        steps = max(1, args.epochs * (len(ids) // max(B * S, 1)))
        t0, loss = time.time(), None
        for k in range(steps):
            starts = rng.integers(0, len(ids) - S - 1, B)
            tokens = np.stack([ids[s:s + S] for s in starts])
            targets = np.stack([ids[s + 1:s + S + 1] for s in starts])
            params, opt_state, loss = step(params, opt_state,
                                           torch.from_numpy(tokens),
                                           torch.from_numpy(targets))
            if args.verbose and (k + 1) % 20 == 0:
                print(f"step {k + 1}/{steps} loss {float(loss):.4f}")
        final = float(loss)               # waits for the last step
        tok_rate = steps * B * S / max(time.time() - t0, 1e-9)
        print(f"Trained {steps} steps (final loss {final:.4f}, "
              f"{tok_rate:.0f} tokens/sec)")
        out.mkdir(parents=True, exist_ok=True)
        (out / "lm_config.json").write_text(
            json.dumps(dataclasses.asdict(cfg)))
        tree_to_npz(out / "lm_params.npz", params)   # atomic write
        print(f"LM saved to {out}")
    if args.eval is not None:
        _lm_eval(args.eval, cfg, params)
    if args.generate is not None:
        _lm_generate(args, cfg, params)
    return 0


def _lm_generate(args, cfg: TransformerConfig, params) -> None:
    """``-generate``: decode from the prompt's bytes (a newline when none
    is given) and print the text; ``-beam`` > 1 runs beam search and
    prints its log-prob to stderr."""
    from deeplearning4j_tpu_torch.parallel.generation import (
        beam_search,
        generate,
    )

    prompt = np.frombuffer((args.generate or "\n").encode(),
                           np.uint8).astype(np.int64)
    if len(prompt) + args.max_new > cfg.max_len:
        raise SystemExit(
            f"prompt ({len(prompt)} bytes) + -max-new ({args.max_new}) "
            f"exceeds the model's context ({cfg.max_len}, set by -seq at "
            f"training time); shorten one of them")
    dev = params["embed"].device
    if args.beam > 1:
        toks, scores = beam_search(cfg, params, prompt[None, :],
                                   args.max_new, beam_size=args.beam,
                                   device=dev)
        print(f"beam[{args.beam}] log-prob {float(scores[0]):.3f}",
              file=sys.stderr)
    else:
        toks = generate(cfg, params, prompt[None, :], args.max_new,
                        temperature=args.temperature, seed=args.gen_seed,
                        top_k=args.top_k, top_p=args.top_p, device=dev)
    print(bytes(toks[0].cpu().numpy().astype(np.uint8)).decode(
        errors="replace"))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="PyTorch / CUDA port of deeplearning4j_tpu")
    sub = parser.add_subparsers(dest="command", required=True)
    def data_args(p):
        p.add_argument("-input", "--input", required=True,
                       help="input data file (svmlight, or csv)")
        p.add_argument("-model", "--model", required=True,
                       help="zoo:<name>, a conf JSON, or a saved model dir")
        p.add_argument("-conf", "--conf", default=None,
                       help="key=value properties file")
        p.add_argument("-output", "--output", default=None)
        p.add_argument("-verbose", "--verbose", action="store_true")
        p.add_argument("-device", "--device", default=None,
                       help="cuda (default) or cpu")

    p = sub.add_parser("train", help="train a MultiLayerNetwork on a "
                       "CSV / SVMLight file and save it")
    data_args(p)
    p.add_argument("-type", "--type", choices=["multi", "single"],
                   default="multi")
    p.add_argument("-savemode", "--savemode", choices=["binary", "txt"],
                   default="binary")
    p.add_argument("-epochs", "--epochs", type=int, default=50)
    p.add_argument("-batch", "--batch", type=int, default=32)
    p.add_argument("-accum", "--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per update")
    # accepted so that a JAX command line fails with the reason
    p.add_argument("-runtime", "--runtime", choices=["local", "spmd"],
                   default="local", help="only local is ported")
    p.add_argument("-replicas", "--replicas", type=int, default=None,
                   help="not ported (spmd)")
    p.add_argument("-sync-every", "--sync-every", dest="sync_every",
                   type=int, default=1, help="not ported (spmd)")
    p.add_argument("-precision", "--precision",
                   choices=["fp32", "bf16", "mixed"], default="fp32",
                   help="precision policy: fp32, bf16 (bf16 params and "
                   "compute) or mixed (f32 masters, bf16 compute, dynamic "
                   "loss scaling)")
    p.add_argument("-chunk", "--chunk", type=int, default=1,
                   help="optimizer steps a dispatch through the fused "
                   "driver (1 = one step a batch)")
    p.add_argument("-resilience", "--resilience", action="store_true",
                   help="not ported")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="not ported")
    p.add_argument("-ckpt-dir", "--ckpt-dir", dest="ckpt_dir",
                   default=None, help="not ported (resilience)")
    p.add_argument("-ckpt-every", "--ckpt-every", dest="ckpt_every",
                   type=int, default=None, help="not ported (resilience)")
    p.add_argument("-ckpt-keep", "--ckpt-keep", dest="ckpt_keep",
                   type=int, default=None, help="not ported (resilience)")
    p.add_argument("-metrics-port", "--metrics-port", dest="metrics_port",
                   type=int, default=None,
                   help="serve training telemetry at GET /metrics on this "
                   "port (0 = a free port)")
    p.add_argument("-metrics-interval", "--metrics-interval",
                   dest="metrics_interval", type=int, default=10,
                   help="steps between telemetry syncs (each reads the "
                   "loss back from the device)")
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("test", help="evaluate a saved model")
    data_args(p)
    p.set_defaults(func=cmd_test)

    p = sub.add_parser("predict", help="write a saved model's argmax "
                       "classes, one a line")
    data_args(p)
    p.set_defaults(func=cmd_predict)

    def classifier_args(p, fleet: bool = False):
        p.add_argument("-model", "--model", default=None,
                       help="zoo:<name>, a conf JSON, or a saved model dir "
                       "for POST /model/predict")
        p.add_argument("-max-batch", "--max-batch", dest="max_batch",
                       type=int, default=32,
                       help="most rows one coalesced dispatch carries")
        p.add_argument("-max-wait-ms", "--max-wait-ms", dest="max_wait_ms",
                       type=float, default=2.0,
                       help="how long the micro-batcher holds a request "
                       "open for co-travellers")
        p.add_argument("-buckets", "--buckets", default="1,8,32",
                       help="comma-separated batch bucket ladder; every "
                       "dispatch pads up to the next bucket")
        p.add_argument("-quantize", "--quantize", choices=["none", "int8"],
                       default="none",
                       help="serve int8 per-channel weight-quantized dense "
                       "and conv layers")
        p.add_argument("-host", "--host", default="127.0.0.1")
        p.add_argument("-port", "--port", type=int, default=8080,
                       help="0 picks a free port" + (
                           "; each replica gets its own free port"
                           if fleet else ""))
        p.add_argument("-device", "--device", default=None,
                       help="cuda (default) or cpu")
        p.add_argument("-serve-seconds", "--serve-seconds",
                       dest="serve_seconds", type=float, default=0.0,
                       help="stop after this many seconds (0 = until "
                       "SIGTERM)")
        p.add_argument("-drain-grace-s", "--drain-grace-s",
                       dest="drain_grace_s", type=float, default=5.0,
                       help="SIGTERM grace window: seconds to let queued "
                       "and in-flight work finish before stopping")
        p.add_argument("-max-queue", "--max-queue", dest="max_queue",
                       type=int, default=256,
                       help="bounded admission: queued requests past this "
                       "depth are refused with 503 + Retry-After (0 = "
                       "unbounded)")
        p.add_argument("-deadline-ms", "--deadline-ms", dest="deadline_ms",
                       type=float, default=0,
                       help="default per-request deadline; expired "
                       "requests are shed before dispatch as 504 (0 = "
                       "none; a request's deadline_ms or X-Deadline-Ms "
                       "overrides it)")
        p.add_argument("-breaker-threshold", "--breaker-threshold",
                       dest="breaker_threshold", type=int, default=5,
                       help="circuit breaker: consecutive failed dispatches "
                       "before admission fails fast (0 = no breaker)")
        p.add_argument("-warmup", "--warmup", action="store_true",
                       help="run every bucket shape (and LM dispatch width) "
                       "before accepting traffic")
        p.add_argument("-lm-slots", "--lm-slots", dest="lm_slots", type=int,
                       default=4, help="concurrent decode lanes")
        p.add_argument("-page-size", "--page-size", dest="page_size",
                       type=int, default=16, help="tokens per KV page")
        p.add_argument("-prefill-chunk", "--prefill-chunk",
                       dest="prefill_chunk", type=int, default=8,
                       help="prompt tokens fed per dispatch")

    p = sub.add_parser("serve", help="serve a classifier and/or a saved LM "
                       "over HTTP")
    classifier_args(p)
    p.add_argument("-lm", "--lm", default=None,
                   help="directory holding lm_config.json + lm_params.npz")
    p.add_argument("-lm-kv", "--lm-kv", dest="lm_kv",
                   choices=("paged", "dense"), default="paged",
                   help="KV cache of the pool: the paged pool with radix "
                   "prefix reuse (default) or a dense max_len row per slot")
    p.add_argument("-lm-pages", "--lm-pages", dest="lm_pages", type=int,
                   default=0, help="usable KV pages (0 = slots x "
                   "pages per max_len sequence)")
    p.add_argument("-lm-speculate", "--lm-speculate", dest="lm_speculate",
                   choices=("off", "ngram", "model"), default="off",
                   help="speculative decoding of greedy lanes (paged KV "
                   "only): 'ngram' drafts by prompt lookup on the host, "
                   "'model' with the served model itself")
    p.add_argument("-lm-draft-len", "--lm-draft-len", "-draft-len",
                   "--draft-len", dest="draft_len", type=int, default=4,
                   help="most draft tokens a lane proposes per round")
    p.add_argument("-lm-ship", "--lm-ship", dest="lm_ship",
                   action="store_true",
                   help="answer POST /lm/prefill (the lane's KV pages at "
                   "prefill completion) and /lm/admit_pages (decode a "
                   "shipped lane); paged KV only")
    p.add_argument("-lm-preempt", "--lm-preempt", dest="lm_preempt",
                   action="store_true",
                   help="priority preemption: a request that would wait "
                   "on a dry pool swaps the lowest-priority lane out to "
                   "a host store; it resumes on re-admission (paged KV)")
    p.add_argument("-lm-swap-mb", "--lm-swap-mb", dest="lm_swap_mb",
                   type=float, default=64.0,
                   help="host swap store cap in MiB (LRU past it; an "
                   "evicted lane recomputes from its prompt)")
    p.add_argument("-lm-brownout", "--lm-brownout", dest="lm_brownout",
                   action="store_true",
                   help="brownout ladder: under pool pressure turn "
                   "speculation off, narrow the prefill, preempt and "
                   "then shed best_effort work (paged KV)")
    p.add_argument("-lm-hibernate-idle-s", "--lm-hibernate-idle-s",
                   dest="lm_hibernate_idle_s", type=float, default=None,
                   help="hibernate a session's KV pages to the tiered "
                   "store after this many idle seconds; the next request "
                   "on its prefix resumes them (paged KV)")
    p.add_argument("-lm-disk-dir", "--lm-disk-dir", dest="lm_disk_dir",
                   default=None,
                   help="disk tier of the state store: host overflow "
                   "spills here, and a restarted server over the same "
                   "dir resumes hibernated sessions (needs "
                   "-lm-hibernate-idle-s or -lm-preempt)")
    p.add_argument("-lm-disk-mb", "--lm-disk-mb", dest="lm_disk_mb",
                   type=float, default=1024.0,
                   help="disk tier cap in MiB (LRU past it)")
    p.add_argument("-lm-swap-quantize", "--lm-swap-quantize",
                   dest="lm_swap_quantize", choices=("on", "off"),
                   default="on",
                   help="per-page int8 swapped-out and hibernated frames "
                   "(~4x smaller); 'off' keeps exact bytes")
    p.add_argument("-drain-stats", "--drain-stats", dest="drain_stats",
                   default="serving_stats.json",
                   help="path of the /serving/stats snapshot written on a "
                   "SIGTERM drain")
    p.add_argument("-tenants", "--tenants", default=None,
                   help="multi-tenant traffic shaping (JSON): tenant name "
                   "-> spec, e.g. '{\"interactive\": {\"weight\": 4, "
                   "\"rate\": 2000, \"slo_ms\": 250}}'; a spec takes "
                   "weight (WFQ share), rate (tokens/s; 0 = unmetered), "
                   "burst, slo_ms and slo_budget; the 'default' tenant "
                   "always exists")
    p.set_defaults(func=cmd_serve)

    p = sub.add_parser("serve-fleet", help="serve a classifier and/or a "
                       "saved LM through a fleet of thread-hosted replicas "
                       "behind a failover router")
    classifier_args(p, fleet=True)
    p.add_argument("-lm", "--lm", default=None,
                   help="saved LM dir served by every replica's paged pool")
    p.add_argument("-replicas", "--replicas", type=int, default=2,
                   help="replicas spawned into rotation (ignored when "
                   "-prefill-workers/-decode-workers split the fleet)")
    p.add_argument("-prefill-workers", "--prefill-workers",
                   dest="prefill_workers", type=int, default=0,
                   help="replicas that prefill long prompts and ship the "
                   "KV pages to decode workers (needs -lm and "
                   "-decode-workers)")
    p.add_argument("-decode-workers", "--decode-workers",
                   dest="decode_workers", type=int, default=0,
                   help="replicas that run the token loop (and take "
                   "short prompts directly)")
    p.add_argument("-disagg-min-prompt", "--disagg-min-prompt",
                   dest="disagg_min_prompt", type=int, default=32,
                   help="prompts at least this long split prefill->decode "
                   "when prefill workers exist")
    p.add_argument("-lm-ship", "--lm-ship", dest="lm_ship",
                   action="store_true",
                   help="page shipping on both-role replicas too (sticky "
                   "session spill-over ships instead of recomputing)")
    p.add_argument("-health-interval-s", "--health-interval-s",
                   dest="health_interval_s", type=float, default=1.0,
                   help="router /readyz poll interval")
    p.add_argument("-autoscale", "--autoscale", action="store_true",
                   help="queue-depth-driven scale up/down through "
                   "graceful drain")
    p.add_argument("-min-replicas", "--min-replicas", dest="min_replicas",
                   type=int, default=1)
    p.add_argument("-max-replicas", "--max-replicas", dest="max_replicas",
                   type=int, default=8)
    p.add_argument("-drain-stats", "--drain-stats", dest="drain_stats",
                   default="fleet_stats.json",
                   help="where the final /fleet/stats snapshot is written "
                   "on a SIGTERM drain")
    # accepted so that a JAX command line fails with the reason
    p.add_argument("-processes", "--processes", action="store_true",
                   help="not ported (process-per-replica)")
    for flag, kind in (("worker-base-port", int), ("worker-log-dir", str),
                       ("restart-backoff-s", float),
                       ("crash-loop-threshold", int),
                       ("crash-loop-window-s", float),
                       ("ready-timeout-s", float)):
        p.add_argument(f"-{flag}", f"--{flag}",
                       dest=flag.replace("-", "_"), type=kind, default=None,
                       help="with -processes (not ported)")
    p.set_defaults(func=cmd_serve_fleet)

    p = sub.add_parser("lm", help="train a TransformerLM on raw text "
                       "and save it")
    p.add_argument("-input", "--input", default=None,
                   help="raw text file (omit to load a saved LM)")
    p.add_argument("-output", "--output", default=None,
                   help="save/load directory (default dl4j-lm)")
    p.add_argument("-epochs", "--epochs", type=int, default=1)
    p.add_argument("-batch", "--batch", type=int, default=8)
    p.add_argument("-seq", "--seq", type=int, default=128)
    p.add_argument("-preset", "--preset", choices=sorted(PRESETS),
                   default=None, help="config preset (small 768/12/12, "
                   "medium 1024/16/24, large 1280/20/36; tied embeddings, "
                   "remat) overriding -d-model/-layers/-heads")
    p.add_argument("-accum", "--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step")
    p.add_argument("-d-model", "--d-model", dest="d_model", type=int,
                   default=128)
    p.add_argument("-layers", "--layers", type=int, default=2)
    p.add_argument("-heads", "--heads", type=int, default=4)
    p.add_argument("-lr", "--lr", type=float, default=3e-3)
    p.add_argument("-updater", "--updater", default="adam",
                   choices=["sgd", "adam", "adamw", "lion", "rmsprop",
                            "adagrad", "nesterovs"])
    p.add_argument("-eval", "--eval", default=None,
                   help="report byte-level perplexity on this held-out "
                   "text file")
    p.add_argument("-verbose", "--verbose", action="store_true")
    p.add_argument("-device", "--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("-experts", "--experts", type=int, default=0,
                   help="MoE experts per block (0 = dense MLP; capacity "
                   "dispatch in training, dense-masked at inference)")
    p.add_argument("-moe-top-k", "--moe-top-k", dest="moe_top_k", type=int,
                   default=1, help="experts routed per token (1 = Switch, "
                   "2 = GShard-style)")
    # accepted so that a JAX command line fails with the reason
    p.add_argument("-runtime", "--runtime", default="local",
                   choices=["local", "spmd", "hybrid", "pipeline"],
                   help="only local is ported")
    p.add_argument("-generate", "--generate", nargs="?", const="",
                   default=None, metavar="PROMPT",
                   help="decode after training/loading (optional prompt)")
    p.add_argument("-max-new", "--max-new", dest="max_new", type=int,
                   default=64)
    p.add_argument("-temperature", "--temperature", type=float, default=0.8)
    p.add_argument("-top-k", "--top-k", dest="top_k", type=int, default=0,
                   help="sample from the k most likely tokens (0 = all)")
    p.add_argument("-top-p", "--top-p", dest="top_p", type=float,
                   default=1.0, help="nucleus sampling mass")
    p.add_argument("-gen-seed", "--gen-seed", dest="gen_seed", type=int,
                   default=0)
    p.add_argument("-beam", "--beam", type=int, default=1,
                   help="beam-search width for -generate (1 = off)")
    p.set_defaults(func=cmd_lm)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
