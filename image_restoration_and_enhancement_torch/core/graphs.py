"""CUDA graphs of the serving functions: the port's counterpart of ``jax.jit``.

The JAX package runs each sampling function as one compiled program
(``jax.jit``, one per input shape and closed-over settings), with no host
round-trip between steps. Here a serving function is split in two:

- ``prepare(*args, generator=None, noise=None)``: the host's part. It moves the inputs
  to the device and draws the noise from the caller's generator (or takes the
  given noise), exactly as the eager function does, and returns a tuple of
  device tensors (None for an absent one, e.g. the uncond context without CFG);
- ``run(*tensors) -> image``: the device's part, the region a graph captures.
  It copies nothing between the host and the device.

``GraphedServe`` keeps one ``torch.cuda.CUDAGraph`` of ``run`` per input
signature (each input's shape, stride and dtype, or its absence; the stack's
quantization, ToMe and int8-attention settings; the TF32 switches). The first
call of a signature runs ``run`` eagerly on the stack's capture stream (the
warm-up: it builds the kernels, creates the cuBLAS and cuDNN handles and their
workspaces, fills the port's caches), returns that result, and captures; every
later call copies its inputs into the graph's static buffers, replays, and
returns a clone of the output. A failed capture or replay raises; nothing
falls back to the eager function.

Host bookkeeping that a replay would skip is replayed by hand
(``Bookkeeping``): the launches a capture recorded in ``ops/_build``'s
counters are taken out of them again (nothing ran) and added back at each
replay, and the int8_static table misses the capture met are added to the
``QuantState`` at each replay. The counters then count the launches issued,
request by request, as they do eagerly.

The graphs of one stack share one memory pool, one capture stream and one lock
(``GraphPool``, made by ``SDModules.graph_pool``); they are never replayed
concurrently. A graph holds the addresses it was captured with: the static
buffers, the port's cached index tensors, the int8 conv's split-K scratch
(``ops/conv_int8.py`` keeps an outgrown one), the quantization state it read
(the graph keeps a reference to it) and the weights. A weight updated in place
(``load_state_dict``, the trainer's ``copy_``) is seen by the next replay of a
full-precision serve. Under an int8 mode the graph reads each quantized layer's
s8 copy of its weight instead, which is remade when the weight changes: a
change of any quantized weight's address or version
(``SDModules.quantized_weights``) drops the function's graphs, and the next
call captures anew. A parameter replaced by another tensor is not seen by a
full-precision graph: load weights in place.

Each graph keeps its ``cudaGraph_t`` beside the executable one
(``keep_graph``), so that ``graph_nodes`` can read what it launches from the
CUDA driver: the kernel nodes by name, which a check holds to the eager
function's launches.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import threading
from typing import Callable, Dict, FrozenSet, Iterator, Optional, Tuple

import torch

from ..ops import _build
from ..parallel import spatial

Inputs = Tuple[Optional[torch.Tensor], ...]


def signature(inputs: Inputs) -> tuple:
    """The part of a graph's key that the inputs give: per input None, or its
    (shape, stride, dtype)."""
    return tuple(None if t is None else (tuple(t.shape), t.stride(), t.dtype) for t in inputs)


def resolve(graph: Optional[bool], device: torch.device) -> bool:
    """``graph`` of a sampling factory: None means a graph on ``cuda`` and the
    eager function on ``cpu``; True on a CPU stack raises."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA stack; these modules are on {device}")
    return bool(graph)


@dataclasses.dataclass
class GraphPool:
    """What the graphs of one stack share: the memory pool, the stream the
    warm-ups and captures run on, and the lock that serialises replays."""

    handle: tuple
    stream: "torch.cuda.Stream"
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @classmethod
    def create(cls, device: torch.device) -> "GraphPool":
        return cls(torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))


@dataclasses.dataclass
class Bookkeeping:
    """What a capture recorded on the host: launches by kernel, by (kernel,
    shape) and by (kernel, path), and the quantized sites missing from the
    static table."""

    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    paths: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    misses: FrozenSet[str] = frozenset()

    @classmethod
    @contextlib.contextmanager
    def capture(cls, quant_state=None) -> Iterator["Bookkeeping"]:
        """Record what the block adds to the launch counters and to
        ``quant_state.misses``, then take it out again: a captured launch does
        not run. The record is filled when the block exits, also by an
        exception."""
        book = cls()
        counters = (_build.launch_counts, _build.launch_shapes, _build.launch_paths)
        before = [collections.Counter(c) for c in counters]
        prev_misses = None
        if quant_state is not None:
            prev_misses, quant_state.misses = quant_state.misses, set()
        try:
            yield book
        finally:
            for counter, old, mine in zip(counters, before, (book.counts, book.shapes,
                                                              book.paths)):
                mine.update(collections.Counter(counter) - old)
                counter.clear()
                counter.update(old)
            if quant_state is not None:
                book.misses = frozenset(quant_state.misses)
                quant_state.misses = prev_misses

    def replay(self, quant_state=None) -> None:
        """Add the recorded launches and misses, as a replay issues them."""
        _build.launch_counts.update(self.counts)
        _build.launch_shapes.update(self.shapes)
        _build.launch_paths.update(self.paths)
        if self.misses and quant_state is not None:
            quant_state.misses |= self.misses


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    static: Inputs
    output: torch.Tensor
    book: Bookkeeping
    quant: object  # the QuantState the graph read: kept alive, its id is in the key


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS`` (v2) of the CUDA driver API."""

    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_NODE_TYPES = {1: "<memcpy>", 2: "<memset>", 3: "<host>", 4: "<child graph>", 5: "<empty>",
               6: "<wait event>", 7: "<event record>", 10: "<mem alloc>", 11: "<mem free>"}


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> collections.Counter:
    """The nodes of a captured graph, read from the CUDA driver: each kernel
    node under its kernel's (mangled) name, every other node under its type
    ("<memcpy>", "<memset>", ...). A replay launches exactly these."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", cu.cuGraphKernelNodeGetParams)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = collections.Counter()
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:
            out[_NODE_TYPES.get(kind.value, f"<node type {kind.value}>")] += 1
            continue
        params = _KernelNodeParams()
        check(get_params(node, ctypes.byref(params)), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        out[name.value.decode()] += 1
    return out


class GraphedServe:
    """A serving function replayed from CUDA graphs (see the module
    docstring). ``modules`` is the ``SDModules`` stack ``run`` computes on;
    ``prepare`` and ``run`` are the two parts of the eager function."""

    def __init__(self, modules, prepare: Callable[..., Inputs], run: Callable[..., torch.Tensor]):
        if modules.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA stack, not {modules.device}")
        self.modules = modules
        self.prepare = prepare
        self.run = run
        self.graphs: Dict[tuple, _Captured] = {}
        self.last: Optional[_Captured] = None  # the graph the last call captured or replayed
        self._weights: tuple = ()

    def key(self, inputs: Inputs) -> tuple:
        """The graph a call replays: the inputs' signature and what a capture
        freezes of the stack and of torch's switches."""
        return signature(inputs) + self.modules.graph_settings() + (
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    @torch.inference_mode()
    def __call__(self, *args, **kwargs) -> torch.Tensor:
        """The eager function's call: its arguments go to ``prepare``."""
        if spatial.active() is not None:
            raise ValueError("a graphed serving function does not run under a sharding "
                             "policy; build it with graph=False")
        inputs = self.prepare(*args, **kwargs)
        key = self.key(inputs)
        pool = self.modules.graph_pool()
        with pool.lock:
            weights = self.modules.quantized_weights()
            if weights != self._weights:  # the graphs read s8 weights that are remade
                self.graphs.clear()
                self.last, self._weights = None, weights
            entry = self.graphs.get(key)
            if entry is None:
                return self._capture(key, inputs, pool)
            for dst, src in zip(entry.static, inputs):
                if dst is not None:
                    dst.copy_(src)
            entry.graph.replay()
            entry.book.replay(self.modules.quant)
            self.last = entry
            return entry.output.clone()

    def _capture(self, key: tuple, inputs: Inputs, pool: GraphPool) -> torch.Tensor:
        """Warm up on the capture stream, capture, and return the warm-up's
        output (the request's answer)."""
        static = tuple(None if t is None else t.clone() for t in inputs)
        current = torch.cuda.current_stream(self.modules.device)
        pool.stream.wait_stream(current)
        with torch.cuda.stream(pool.stream):
            warm = self.run(*static)
        current.wait_stream(pool.stream)
        warm.record_stream(current)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with Bookkeeping.capture(self.modules.quant) as book:
            with torch.cuda.graph(graph, pool=pool.handle, stream=pool.stream):
                output = self.run(*static)
        graph.instantiate()
        self.last = self.graphs[key] = _Captured(graph, static, output, book, self.modules.quant)
        return warm
