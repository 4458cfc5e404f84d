"""Plotting iteration listeners (counterpart of
`deeplearning4j_tpu.plot.listeners`).

Parity: reference `plot/iterationlistener/*.java` — listeners that render
weight filters / activations every N iterations during training. They plug
into the same listener SPI the optimizers fire (optimize/api.py), matching
`BaseOptimizer.java:169` / `MultiLayerNetwork.java:1112`.  The port's
network keeps its weights and activations as tensors (on the card, maybe
bfloat16); the renderer reads them to the host as float32.
"""

from __future__ import annotations

import os
from typing import Optional

from deeplearning4j_tpu_torch.plot.renderers import FilterRenderer, host_array


class PlotFiltersIterationListener:
    """Render the first dense/conv layer's W as a filter grid every N
    iterations (PlotFiltersIterationListener.java)."""

    def __init__(self, net, out_dir: str, every: int = 10,
                 param_path: Optional[tuple] = None):
        self.net = net
        self.out_dir = out_dir
        self.every = max(1, every)
        self.param_path = param_path
        self.renderer = FilterRenderer()
        os.makedirs(out_dir, exist_ok=True)

    def _first_weight(self):
        params = self.net.params
        node = params
        if self.param_path:
            for k in self.param_path:
                node = node[k]
            return node
        layers = params if isinstance(params, (list, tuple)) else [
            params[k] for k in sorted(params, key=str)]
        for layer in layers:
            if isinstance(layer, dict) and "W" in layer:
                return layer["W"]
        return None

    def __call__(self, iteration: int, score: float) -> None:
        if iteration % self.every:
            return
        w = self._first_weight()
        if w is None:
            return
        self.renderer.render(
            host_array(w), os.path.join(self.out_dir,
                                        f"filters_{iteration:06d}.png"))


class ActivationRenderListener:
    """Render activations of a probe batch every N iterations."""

    def __init__(self, net, probe_x, out_dir: str, every: int = 10):
        self.net = net
        self.probe_x = probe_x
        self.out_dir = out_dir
        self.every = max(1, every)
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, iteration: int, score: float) -> None:
        if iteration % self.every:
            return
        acts = self.net.feed_forward(self.probe_x)[-1]
        FilterRenderer().render(
            host_array(acts).T,
            os.path.join(self.out_dir, f"activations_{iteration:06d}.png"))
