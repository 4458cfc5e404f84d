"""Training -> UI listeners (counterpart of `deeplearning4j_tpu.ui.listeners`).

Parity: reference `ui/weights/HistogramIterationListener.java:61` — fires
per iteration, POSTs a ModelAndGradient JSON (weight summaries + score)
to the UI server's /weights endpoint.  The summaries are taken in float32
on the host, as the JAX package takes them from its float32 parameters.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import torch


def _host_array(node) -> np.ndarray:
    if isinstance(node, torch.Tensor):
        return node.detach().float().cpu().numpy()
    return np.asarray(node, np.float32)


def _summaries(tree) -> dict:
    out = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for k, v in enumerate(node):
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            arr = _host_array(node)
            hist, edges = np.histogram(arr.ravel(), bins=20)
            out[prefix] = {
                "mean": float(arr.mean()),
                "std": float(arr.std()),
                "min": float(arr.min()),
                "max": float(arr.max()),
                "hist": hist.tolist(),
                "edges": edges.tolist(),
            }

    rec("", tree)
    return out


class HistogramIterationListener:
    """POST weight summaries + score to the UI server every N iterations
    (``net.add_listener(HistogramIterationListener(net, url))``)."""

    def __init__(self, net, url: str, every: int = 1,
                 timeout: float = 5.0):
        self.net = net
        self.url = url.rstrip("/") + "/weights"
        self.every = max(1, every)
        self.timeout = timeout
        self.failures = 0

    def payload(self, iteration: int, score: float) -> dict:
        """The JSON body posted at `iteration`."""
        return {"iteration": iteration, "score": float(score),
                "weights": _summaries(self.net.params)}

    def __call__(self, iteration: int, score: float) -> None:
        if iteration % self.every:
            return
        req = urllib.request.Request(
            self.url, data=json.dumps(self.payload(iteration,
                                                   score)).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except OSError:
            self.failures += 1  # UI down must never kill training
