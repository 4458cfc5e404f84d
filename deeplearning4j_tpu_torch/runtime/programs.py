"""Serving programs: a step built once for its input signature and
replayed after that.  No JAX twin: this is the port's counterpart of a
jitted, donated XLA program.

A `Program` wraps a step function that takes no arguments: it reads its
inputs from static tensors (`StaticInputs`, filled from the host before
each call) and from tensors it holds by address (parameters, KV pools),
and returns its outputs.

- On a CUDA device the first call runs the step once, eagerly (this
  builds the kernels' library, sets the kernels' shared-memory
  attributes and the launch plans, and creates the thread's cuBLAS
  handle), then captures it into a `torch.cuda.CUDAGraph` on the
  device's capture stream (``capture_error_mode="thread_local"``, in the
  memory pool the caller shares among one server's programs) and reports
  ONE event to the compile watcher: the wall seconds of the warm run
  plus the capture, under the `compile_scope` active on the calling
  thread.  It returns the warm run's outputs.  Every later call replays
  the graph on the caller's stream and returns the static outputs, which
  the caller consumes before the next replay of any program of the same
  pool.
- The warm run runs on the caller's stream, and every capture on one
  stream per device, one capture at a time in the process: cuBLAS keeps a
  workspace per (thread, stream), and a graph replays with the workspace
  of its capture, so the capture stream's workspaces serve replays only,
  in the order of the caller's stream, and no other work runs there.
- On the CPU (only where the caller asked for it) the first call runs
  the step eagerly and reports the same one event; later calls run it
  eagerly.  The counting contract is the same on both devices.

A capture that fails raises, naming the program and the CUDA error:
nothing retries eagerly.  The kernels' Python-side launch counters count
the warm run (it executes), nothing during the capture (it executes
nothing), and each replay adds the launches the capture recorded
(`parallel.kernels.counting_into`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.obs.compilewatch import (
    COMPILE_EVENT,
    compile_watcher,
)
from deeplearning4j_tpu_torch.parallel.kernels import counting_into

_ALIGN = 16
_capture_lock = threading.Lock()
_capture_streams: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The device's capture stream (call with `_capture_lock` held)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream(index)
    return _capture_streams[index]


class StaticInputs:
    """Named host arrays of fixed shapes and dtypes, held in static device
    tensors (`tensors`) and filled in one copy: on the card from one
    pinned staging buffer, on the CPU in place."""

    def __init__(self, device: torch.device,
                 spec: Dict[str, Tuple[Tuple[int, ...], Any]]):
        self.device = torch.device(device)
        layout, off = {}, 0
        for name, (shape, dt) in spec.items():
            dt = np.dtype(dt)
            shape = tuple(int(s) for s in shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            layout[name] = (off, nbytes, shape, dt)
            off += -(-nbytes // _ALIGN) * _ALIGN
        self.nbytes = max(off, _ALIGN)
        cuda = self.device.type == "cuda"
        self._dev = torch.zeros(self.nbytes, dtype=torch.uint8,
                                device=self.device)
        self._host = (torch.zeros(self.nbytes, dtype=torch.uint8,
                                  pin_memory=True) if cuda else self._dev)
        self._copied = torch.cuda.Event() if cuda else None
        host = self._host.numpy()
        self.tensors: Dict[str, torch.Tensor] = {}
        self._arrays: Dict[str, np.ndarray] = {}
        for name, (off, nbytes, shape, dt) in layout.items():
            tdt = torch.from_numpy(np.zeros(0, dt)).dtype
            self.tensors[name] = self._dev[off:off + nbytes].view(
                tdt).view(shape)
            self._arrays[name] = host[off:off + nbytes].view(dt).reshape(
                shape)

    def put(self, **arrays) -> None:
        """Write each named array (of exactly its shape) and move them in
        one copy, once the previous copy has read the staging buffer."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            dst = self._arrays[name]
            a = np.asarray(a)
            if a.shape != dst.shape:
                raise ValueError(f"{name} has shape {a.shape}, the program "
                                 f"takes {dst.shape}")
            dst[...] = a
        if self._copied is not None:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied.record(torch.cuda.current_stream(self.device))


class Program:
    """`fn()` built once and replayed (see the module docstring).  `key`
    names the program in errors; the watcher's key is the caller's
    `compile_scope`.  `pool` is a `torch.cuda.graph_pool_handle()`
    shared by one server's programs (None on the CPU)."""

    def __init__(self, key: str, fn: Callable[[], Any],
                 device: torch.device, pool=None):
        self.key = str(key)
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.build_s: Optional[float] = None   # warm run + capture
        self.replays = 0      # calls after the build (eager on the CPU)
        self._tally: Dict[Tuple[Any, Any], int] = {}

    @property
    def built(self) -> bool:
        return self.build_s is not None

    def __call__(self):
        if self.build_s is None:
            return self._build()
        self.replays += 1
        if self.graph is None:
            with torch.no_grad():
                return self.fn()
        self.graph.replay()
        for (counter, key), n in self._tally.items():
            counter.add(n, key=key)
        return self.outputs

    def _build(self):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = self.fn()                       # the warm run
        if self.device.type != "cuda":
            self._report(time.perf_counter() - t0)
            return out
        torch.cuda.current_stream(self.device).synchronize()
        graph = torch.cuda.CUDAGraph()
        tally: Dict[Tuple[Any, Any], int] = {}
        with _capture_lock:
            stream = _capture_stream(self.device)
            try:
                with torch.cuda.stream(stream), torch.no_grad(), \
                        counting_into(tally):
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        outputs = self.fn()
                    finally:
                        graph.capture_end()
            except Exception as e:
                raise RuntimeError(
                    f"program {self.key}: CUDA graph capture failed: "
                    f"{type(e).__name__}: {e}") from e
        self.graph, self.outputs, self._tally = graph, outputs, tally
        self._report(time.perf_counter() - t0)
        return out

    def _report(self, seconds: float) -> None:
        self.build_s = seconds
        compile_watcher().record(COMPILE_EVENT, seconds)


def new_pool(device: torch.device):
    """A graph memory pool for one server's programs on `device` (None on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


class BucketPrograms:
    """One forward program per padded input signature (the serving
    ladder's buckets): ``forward(x, mask)`` over static x and mask
    buffers, holding `held()`'s tensors by address.  A program whose held
    tensors moved (new parameters) is built again.  Calls are
    serialized: a program's static outputs are copied to the host before
    the next call."""

    def __init__(self, device: torch.device,
                 forward: Callable[[torch.Tensor, Optional[torch.Tensor]],
                                   torch.Tensor],
                 held: Callable[[], Sequence[torch.Tensor]]):
        self.device = torch.device(device)
        self.forward = forward
        self.held = held
        self.pool = new_pool(self.device)
        self._lock = threading.Lock()
        self._programs: Dict[tuple, tuple] = {}

    def __call__(self, x: np.ndarray, mask: Optional[np.ndarray]
                 ) -> np.ndarray:
        """`forward` of x (and mask) -> a host array."""
        sig = (tuple(x.shape), x.dtype.str, None if mask is None
               else (tuple(mask.shape), mask.dtype.str))
        with self._lock:
            # the addresses the programs read: a program built over
            # other addresses is stale
            held = tuple(t.data_ptr() for t in self.held())
            entry = self._programs.get(sig)
            if entry is None or entry[2] != held:
                spec = {"x": (x.shape, x.dtype)}
                if mask is not None:
                    spec["mask"] = (mask.shape, mask.dtype)
                inputs = StaticInputs(self.device, spec)
                t = inputs.tensors

                def fn(t=t):
                    return self.forward(t["x"], t.get("mask"))

                entry = (inputs, Program(f"forward{sig}", fn, self.device,
                                         self.pool), held)
                self._programs[sig] = entry
            inputs, program, _ = entry
            inputs.put(**({"x": x} if mask is None
                          else {"x": x, "mask": mask}))
            return program().cpu().numpy()


__all__ = ["BucketPrograms", "Program", "StaticInputs", "new_pool"]
