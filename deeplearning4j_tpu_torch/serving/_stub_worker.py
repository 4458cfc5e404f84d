"""Stdlib-only stub serving worker — the process-supervision test body
(counterpart of `deeplearning4j_tpu.serving._stub_worker`).

`FleetSupervisor` (serving/procfleet.py) supervises real OS processes:
it polls exit status, sends real SIGTERM/SIGKILL, and watches a real
port.  Exercising that against full ``cli serve`` workers would cost a
torch import plus model warmup per spawn, so this module is the minimal
honest stand-in: a real process that binds a real port and speaks the
replica endpoint surface the router and supervisor dispatch against
(`/readyz`, `/healthz`, `/serving/stats`, `/model/predict`) — kill -9
it, SIGSTOP it, flake its boot, and the supervisor sees exactly what a
dead/wedged/flaking ``cli serve`` worker looks like, in ~100ms of boot
instead of seconds.

Run it BY FILE PATH (``python .../serving/_stub_worker.py --port N``),
never ``-m``: executing by path skips the ``deeplearning4j_tpu_torch``
package parents entirely, whose ``__init__`` imports torch.  This module
must therefore stay importable with the stdlib alone.
`serving.procfleet.stub_worker_command()` builds the command line.

Faults on tap (all deterministic, flag-driven):
- ``--ready-delay-s S``: /readyz answers 503 for the first S seconds
  (a worker that binds fast but warms slowly);
- ``--never-ready``: /readyz stays 503 forever (the ready-timeout path
  — the supervisor must attach the log tail to its report);
- ``--boot-exit-code N``: print a line and exit N immediately (the
  boot-flake path that drives crash-loop quarantine).

SIGTERM exits 0 after a clean shutdown — the supervisor classifies that
death ``clean``, same as a drained ``cli serve`` worker.
"""

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _StubServer(ThreadingHTTPServer):
    # same restart-after-drain semantics as serving/resilience.py's
    # ServingHTTPServer (not imported: this file must stay stdlib-only)
    allow_reuse_address = True
    daemon_threads = True


class _StubHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # silence stderr per request
        pass

    def _json(self, code: int, payload) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        srv = self.server
        if self.path == "/healthz":
            self._json(200, {"ok": True})
        elif self.path == "/readyz":
            ready = (not srv.never_ready
                     and time.monotonic() - srv.t0 >= srv.ready_delay_s)
            if ready:
                self._json(200, {"ready": True})
            else:
                self._json(503, {"ready": False, "reasons": ["warming"]})
        elif self.path == "/serving/stats":
            with srv.lock:
                n = srv.requests
            # the classifier-plane ledger shape fleet_stats folds
            self._json(200, {
                "classifier": {"requests": n, "rejected": 0, "shed": 0,
                               "deadline_missed": 0, "poison_isolated": 0},
                "uptime_s": time.monotonic() - srv.t0,
                "replicas": srv.replicas,
                "stub_worker": True})
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        srv = self.server
        if self.path != "/model/predict":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length)) if length else {}
            feats = body.get("features") or []
            n = len(feats)
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e)})
            return
        with srv.lock:
            srv.requests += n if n else 1
        self._json(200, {"predictions": [0] * n,
                         "outputs": [[1.0, 0.0, 0.0]] * n})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--ready-delay-s", type=float, default=0.0)
    ap.add_argument("--never-ready", action="store_true")
    ap.add_argument("--boot-exit-code", type=int, default=None)
    # elastic-restart probe: the replica count this incarnation was
    # launched with (a real elastic training worker would size its mesh
    # by it); echoed in /serving/stats so supervision tests can assert a
    # resurrection came back with the REWRITTEN count
    ap.add_argument("-replicas", "--replicas", type=int, default=None)
    args = ap.parse_args(argv)

    if args.boot_exit_code is not None:
        print(f"stub-worker: boot flake — exiting "
              f"{args.boot_exit_code}", flush=True)
        return int(args.boot_exit_code)
    try:
        server = _StubServer((args.host, args.port), _StubHandler)
    except OSError as e:
        # EADDRINUSE etc: the log line is what collision diagnostics read
        print(f"stub-worker: bind failed on {args.host}:{args.port}: "
              f"{e}", flush=True)
        return 98
    server.t0 = time.monotonic()
    server.ready_delay_s = float(args.ready_delay_s)
    server.never_ready = bool(args.never_ready)
    server.requests = 0
    server.replicas = args.replicas
    server.lock = threading.Lock()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"stub-worker: listening on {args.host}:{args.port} "
          f"(pid {os.getpid()})", flush=True)
    while not stop.wait(0.1):
        pass
    server.shutdown()
    server.server_close()
    print("stub-worker: SIGTERM — clean exit", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
