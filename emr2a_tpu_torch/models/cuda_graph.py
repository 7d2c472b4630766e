"""Decode steps replayed from a CUDA graph.

The port's counterpart of the JAX package's jitted decode scans
(``emr2a_tpu/models/qwen3_vl.py``: ``Qwen3VLGenerator._build`` /
``_build_chunked``; ``emr2a_tpu/models/serving.py``: ``_build_chunk``):
JAX compiles a chunk of decode steps into one program, and here one step
(a function that reads and writes a state of device tensors in place) is
captured once and replayed, so the host issues one graph launch a step
instead of a few thousand kernel launches.

``StepGraph(step, state, device).run(n)`` advances ``state`` by ``n``
calls of ``step(state)``. On a CPU device, or with ``eager=True``, each
call runs eagerly (a tensor-parallel step spans several cards' streams,
which one capture does not hold, so its owners pass ``eager=True`` for a
model axis above one card). On a CUDA device the first call runs eagerly
on the graph's own capture stream (the warm-up: the K5/K7 wrappers'
per-stream workspaces and cuBLAS's are allocated there, outside the
graph's memory pool, and stay valid across replays); ``step(state)`` is captured when the first replay is due (a run
that the warm-up finishes captures nothing) and every later call replays
it. A capture that fails raises; nothing falls back to eager steps. The
graph stays valid while ``state``'s tensors do: an owner that refills them
in place replays it for a later request (the generator keeps its graphs
by shape, the continuous batcher one per wave kind). ``CAPTURES`` and
``CAPTURE_MS`` count the captures and the host ms of their warm-up steps
and captures.

Counting (a divergence, ROADMAP.md Queue 3): a replay runs no Python, so
the kernel wrappers' launch counters (each ``*LAUNCHES`` int of the
``ops`` modules) and the modules' forward hooks do not fire. The runner
takes the counters' increments over the capture back out (the capture
launched nothing) and adds them once per replay, and it counts each
replay's forwards of the modules in ``forwards`` (``replayed_forwards``),
as many as the captured step ran. The kernel library's own device-launch
counts (``ops/linear_int8.device_launches``) see the warm-up and the
capture, not the replays.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Sequence

import torch

_REPLAYED = weakref.WeakKeyDictionary()

CAPTURES = 0
CAPTURE_MS = 0.0


def replayed_forwards(module: torch.nn.Module) -> int:
    """The forwards of ``module`` that graph replays have run so far."""
    return _REPLAYED.get(module, 0)


def launch_counters() -> list:
    """(module, name) of every kernel wrapper's launch counter."""
    from emr2a_tpu_torch.ops import (attention, attention_block, decode_attention,
                                     linear_int4, linear_int8, mlp, quant, topk,
                                     vision_flash)
    return [(m, name)
            for m in (attention, attention_block, decode_attention, linear_int4,
                      linear_int8, mlp, quant, topk, vision_flash)
            for name, value in sorted(vars(m).items())
            if name.endswith("LAUNCHES") and isinstance(value, int)]


def clone_state(x):
    """A copy of a step's state (tensors, and lists, tuples, dicts and
    dataclasses of them) with every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone_state(v) for v in x)
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{k: clone_state(v) for k, v in vars(x).items()})
    return x


def state_tensors(x, prefix: str = ""):
    """(path, tensor) of every tensor in a state, in a fixed order."""
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict) or hasattr(x, "__dataclass_fields__"):
        items = x.items() if isinstance(x, dict) else vars(x).items()
        for k, v in items:
            yield from state_tensors(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from state_tensors(v, f"{prefix}[{i}]")


class StepGraph:
    """``step(state)`` captured once on a CUDA device and replayed (see the
    module docstring); eager on a CPU device or with ``eager``. Setting
    ``verify`` holds the next replayed step against the eager step
    (``replay_matches_eager``) and leaves the differing paths in
    ``mismatches``."""

    def __init__(self, step: Callable, state, device,
                 forwards: Sequence[torch.nn.Module] = (), eager: bool = False):
        self.step = step
        self.state = state
        self.device = torch.device(device)
        self.eager = eager or self.device.type != "cuda"
        self.forwards = tuple(forwards)
        self.graph = None
        self.stream = None
        self.steps = 0          # steps advanced, eager and replayed
        self.replays = 0
        self.capture_ms = None  # host ms of the warm-up step and the capture
        self.verify = False
        self.mismatches = None
        self._launches = []     # (module, counter, launches a replay)
        self._calls = []        # (module, forwards a replay)
        self._held = []         # the wrappers' workspaces the graph writes

    def run(self, n: int) -> None:
        """Advance the state by ``n`` steps."""
        if n <= 0:
            return
        if self.eager:
            for _ in range(n):
                self.step(self.state)
            self.steps += n
            return
        if self.stream is None:
            self._warm_up()
            n -= 1
        if n and self.graph is None:
            self._capture()
        if n and self.verify:
            self.verify = False
            self.mismatches = replay_matches_eager(self)
            n -= 1
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        self.steps += n
        for module, name, k in self._launches:
            setattr(module, name, getattr(module, name) + k * n)
        for module, k in self._calls:
            _REPLAYED[module] = _REPLAYED.get(module, 0) + k * n

    def _warm_up(self) -> None:
        """One eager step on the capture stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(current)
        t0 = time.perf_counter()
        with torch.cuda.stream(self.stream):
            self.step(self.state)
        current.wait_stream(self.stream)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.steps += 1

    def _capture(self) -> None:
        """The capture, on the warm-up's stream."""
        global CAPTURES, CAPTURE_MS
        from emr2a_tpu_torch.ops import linear_int8
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        counters = launch_counters()
        calls = {m: 0 for m in self.forwards}

        def seen(module, *args):
            calls[module] += 1

        # a graph that the cyclic collector frees during the capture (an old
        # generator and the graph it kept refer to each other) releases its
        # memory pool there, which invalidates the capture: collect first,
        # as ``torch.cuda.graph`` does, and keep the collector off until the
        # capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            before = [getattr(m, name) for m, name in counters]
            hooks = [m.register_forward_pre_hook(seen) for m in self.forwards]
            # capture_begin / capture_end rather than ``torch.cuda.graph``,
            # which empties the allocator's cache first: the next prefill
            # would cudaMalloc its temporaries again
            graph.capture_begin()
            try:
                self.step(self.state)
            finally:
                graph.capture_end()
                if collecting:
                    gc.enable()
                for hook in hooks:
                    hook.remove()
                after = [getattr(m, name) for m, name in counters]
                for (m, name), b in zip(counters, before):
                    setattr(m, name, b)
        current.wait_stream(self.stream)
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        CAPTURES += 1
        CAPTURE_MS += self.capture_ms
        self.graph = graph
        self._launches = [(m, name, a - b) for (m, name), b, a in zip(counters, before, after)
                          if a != b]
        self._calls = [(m, k) for m, k in calls.items() if k]
        # a workspace the wrappers later replace for this stream stays
        # alive while the graph that writes it does
        self._held = list(linear_int8._workspaces.values())


def replay_matches_eager(runner: StepGraph) -> list:
    """One step replayed from ``runner``'s graph against the same step run
    eagerly on a copy of the state taken just before: the paths of the
    state's tensors that differ in any bit (an empty list when the two
    agree bit for bit: the KV cache written, the logits, the tokens and
    the counters)."""
    if runner.graph is None:
        raise ValueError("the runner has not captured its step yet")
    twin = clone_state(runner.state)
    runner.step(twin)
    runner.run(1)
    return [path for (path, a), (_, b) in zip(state_tensors(runner.state),
                                              state_tensors(twin))
            if not torch.equal(a, b)]
