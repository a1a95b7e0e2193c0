"""Compile-once, asynchronous device programs for the engines.

Counterpart of what XLA gives the JAX engines (horizonnet_tpu/inference.py
and horizonnet_tpu/train/engine.py): an asynchronous ``device_put``, and
one executable compiled for fixed shapes whose inputs are uploaded while
the previous call still runs. Here:

``UploadRing``       a host batch is copied into a pinned staging buffer
                     and from there, by a non-blocking copy on a copy
                     stream, into a device slot; ``put`` returns without
                     waiting for the device. Events order the copy after
                     the program that last read the slot, and the program
                     after the copy.
``CapturedProgram``  a program over fixed tensors, captured once as a
                     torch.cuda.CUDAGraph after an eager warm-up, and
                     replayed: one launch for the whole program.

On the CPU the ring's slots are plain tensors and no event is needed; the
engines capture nothing there, nor under a mesh (parallel/), whose
collectives stay eager.

Spans (utils/profiling.py): ``upload.slot_wait`` where ``put`` waits for a
slot's previous copy, ``program.replay`` around a replay, and, always,
``program.capture`` around a program's warm-up and capture; the host
counters ``program.replays`` and ``program.captures``
(ops/launch_counts.py).
"""

import ctypes
import time

import numpy as np
import torch

from .ops import launch_counts
from .utils import profiling

#: Eager runs of a program before its capture (CapturedProgram).
WARMUP = 2

#: CUgraphNodeType of a kernel node and of an event-record node (libcuda's
#: CU_GRAPH_NODE_TYPE_KERNEL and CU_GRAPH_NODE_TYPE_EVENT_RECORD)
_KERNEL_NODE = 0
_EVENT_RECORD_NODE = 7

#: replays of a captured program, and captures, in this process
replays = 0
captures = 0
launch_counts.register(__name__, "replays", host=True)
launch_counts.register(__name__, "captures", host=True)


class Upload:
    """One batch ``put`` into slot ``slot`` of ``ring``; ``serial`` tells a
    later put into the same slot apart."""

    __slots__ = ("ring", "slot", "serial")

    def __init__(self, ring, slot, serial):
        self.ring, self.slot, self.serial = ring, slot, serial


class UploadRing:
    """``slots`` device buffers of one fixed shape and dtype, each with a
    pinned staging buffer on the card.

    ``put(a)`` copies the host array into the next slot's staging buffer,
    waiting on the host only until that buffer's previous copy has left it,
    and queues its copy to the device on the ring's copy stream, after the
    program that read the slot last (``release``). ``take(up)`` makes the
    current stream wait for the upload and returns the device tensor;
    ``release(up)``, called once the program that reads it is queued, lets
    the next copy into the slot follow that program. A program may take an
    upload again until its slot is put anew (``slots`` puts later); after
    that ``take`` raises.
    """

    def __init__(self, shape, dtype, device, slots):
        self.shape, self.dtype = tuple(shape), dtype
        self.device = torch.device(device)
        self.slots = [torch.empty(self.shape, dtype=dtype, device=self.device)
                      for _ in range(slots)]
        self._serial = [0] * slots
        self._next = 0
        self._cuda = self.device.type == "cuda"
        if not self._cuda:
            self._host = [t.numpy() for t in self.slots]
        else:
            self.stream = torch.cuda.Stream(self.device)
            self._staging = [torch.empty(self.shape, dtype=dtype,
                                         pin_memory=True)
                             for _ in range(slots)]
            self._host = [t.numpy() for t in self._staging]
            self._copied = [torch.cuda.Event(blocking=True)
                            for _ in range(slots)]
            self._consumed = [torch.cuda.Event() for _ in range(slots)]

    def put(self, a):
        """Upload host array ``a`` (the ring's shape and dtype) without
        waiting for the device -> Upload."""
        i = self._next
        self._next = (i + 1) % len(self.slots)
        self._serial[i] += 1
        if self._cuda and not self._copied[i].query():
            with profiling.span("upload.slot_wait"):
                self._copied[i].synchronize()
        np.copyto(self._host[i], a)
        if not self._cuda:
            return Upload(self, i, self._serial[i])
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self._consumed[i])
            self.slots[i].copy_(self._staging[i], non_blocking=True)
            self._copied[i].record(self.stream)
        return Upload(self, i, self._serial[i])

    def take(self, up):
        """The device tensor of ``up``, ready on the current stream."""
        if up.ring is not self or self._serial[up.slot] != up.serial:
            raise RuntimeError(
                "the upload's slot was put again before the upload ran "
                f"(at most {len(self.slots)} puts may wait for a run)")
        if self._cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[up.slot])
        return self.slots[up.slot]

    def release(self, up):
        """The program that reads ``up`` is queued on the current stream:
        the next copy into its slot waits for it."""
        if self._cuda:
            self._consumed[up.slot].record(
                torch.cuda.current_stream(self.device))


def engine_device(device):
    """``device`` with its index (a bare "cuda" is the current card), so
    that an engine can tell a tensor on its device by equality."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


_loaded_libcuda = []


def _libcuda():
    """libcuda, loaded once."""
    if not _loaded_libcuda:
        cu = ctypes.CDLL("libcuda.so.1")
        cu.cuGraphExecEventRecordNodeSetEvent.argtypes = [ctypes.c_void_p] * 3
        _loaded_libcuda.append(cu)
    return _loaded_libcuda[0]


def _node_list(cu, graph):
    """The node handles of a captured ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``."""
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    return [ctypes.c_void_p(nodes[i]) for i in range(n.value)]


def _node_type(cu, node):
    kind = ctypes.c_int(0)
    if cu.cuGraphNodeGetType(node, ctypes.byref(kind)):
        raise RuntimeError("cuGraphNodeGetType failed")
    return kind.value


def graph_nodes(graph):
    """(nodes, kernel nodes) of a captured ``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``, read through libcuda."""
    cu = _libcuda()
    nodes = _node_list(cu, graph)
    return len(nodes), sum(_node_type(cu, n) == _KERNEL_NODE for n in nodes)


def event_record_nodes(graph):
    """{CUevent handle: event-record node} of a captured
    ``torch.cuda.CUDAGraph`` made with ``keep_graph=True``."""
    cu = _libcuda()
    out = {}
    for node in _node_list(cu, graph):
        if _node_type(cu, node) == _EVENT_RECORD_NODE:
            ev = ctypes.c_void_p(0)
            if cu.cuGraphEventRecordNodeGetEvent(node, ctypes.byref(ev)):
                raise RuntimeError("cuGraphEventRecordNodeGetEvent failed")
            out[ev.value] = node
    return out


def check_capture(nodes, kernels, launched):
    """Raise unless a capture recorded the program: a graph with no node,
    or with fewer kernel nodes than the kernel wrappers launched while it
    was captured, ran (some of) the program eagerly on another device or
    stream, and every replay would skip it."""
    if nodes == 0:
        raise RuntimeError("the captured graph is empty: the program ran "
                           "on another device or stream than the capture")
    if kernels < launched:
        raise RuntimeError(f"the kernel wrappers launched {launched} "
                           f"kernels during the capture but the graph "
                           f"holds {kernels} kernel nodes: they ran "
                           "outside it")


class CapturedProgram:
    """``fn()``, a program over fixed tensors on CUDA device ``device``,
    captured once as a CUDA graph; ``replay()`` runs it on the device's
    current stream and returns its outputs.

    Warm-up, capture and replay all run with ``device`` current, on a side
    stream made on it, whichever card was current before: a kernel that
    ran on another card's stream would run eagerly once and be missing
    from every replay. Warm-up: ``fn`` runs ``warmup`` times eagerly, so
    the kernels are built, cuDNN and cuBLAS have chosen their algorithms
    and lazy state exists before the capture. What the warm-up writes into
    the tensors of ``keep`` (a train step's parameters, statistics and
    moments) is put back afterwards. A ``generator`` that ``fn`` draws
    from is registered with the graph: each replay draws from its state at
    that moment and advances it.

    The capture runs ``fn`` once more under torch.cuda.graph: the kernels
    are recorded, none runs, and the tensors that ``fn`` returns become
    the outputs, which every replay overwrites. So do the tensors ``fn``
    allocates, which come from the graph's own pool and stay at their
    addresses. A kernel wrapper counts its launch while the capture
    records it (ops/launch_counts.py); the counts are put back, and each
    replay adds the captured launches, kernel by kernel (kernel launch
    counts only: the host counters stay apart). A capture that fails, or
    that recorded less than the wrappers launched (``check_capture``),
    raises: there is no eager fallback.

    Device stages: where ``fn`` calls ``profiling.mark`` at its stage
    boundaries (the serving program: decode, encoder, head, fit; LGT-Net's
    train step: encoder_fwd, swg_fwd, head_loss, swg_bwd, encoder_bwd,
    optim, two of them marked from the backward pass), the graph holds an
    event-record node at each. While tracing is on
    (utils/profiling.py), each replay points those nodes at a set of
    events of its own, taken from a pool, before its launch
    (``cuGraphExecEventRecordNodeSetEvent``), so a later replay in flight
    cannot overwrite them before they are read; the stages' device times
    become ``device.<stage>`` spans once the replay has finished. Off, the
    nodes record into the capture's own events, which nobody reads.
    """

    def __init__(self, fn, device, warmup=WARMUP, keep=(), generator=None):
        global captures
        self.device = torch.device(device)
        keep = list(keep)
        with profiling.span("program.capture", always=True), \
                torch.cuda.device(self.device):
            with torch.no_grad():
                saved = [t.detach().clone() for t in keep]
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            with torch.no_grad():
                for t, s in zip(keep, saved):
                    t.copy_(s)
            del saved
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            if generator is not None:
                self.graph.register_generator_state(generator)
            before = launch_counts.read()
            marks = []
            profiling.collect_marks(marks)
            try:
                with torch.cuda.graph(self.graph, stream=side):
                    self.outputs = fn()
            finally:
                profiling.collect_marks(None)
                after = launch_counts.read()
                launch_counts.write(before)
            #: {(module, count): launches in one replay} of the wrappers
            #: that the program runs
            self.launches = {k: n - before.get(k, 0)
                             for k, n in after.items()
                             if n != before.get(k, 0)}
            check_capture(*graph_nodes(self.graph),
                          sum(self.launches.values()))
            self._stage_nodes(marks)
            self.graph.instantiate()
            captures += 1

    def _stage_nodes(self, marks):
        """The stages between the capture's marks: their names, the
        event-record node of each mark, and the capture's own events,
        which live as long as the graph that records them."""
        self._fixed = [ev for _, ev in marks]
        #: names of the device stages, in order (none without two marks)
        self.stages = [name for name, _ in marks[1:]]
        if not self.stages:
            return
        nodes = event_record_nodes(self.graph)
        self._nodes = [nodes[ev.cuda_event] for ev in self._fixed]
        self._free = []          # event sets to point the nodes at
        self._pointed = False    # the nodes hold a set of the pool

    def _point(self, events):
        cu = _libcuda()
        exe = ctypes.c_void_p(self.graph.raw_cuda_graph_exec())
        for node, ev in zip(self._nodes, events):
            if cu.cuGraphExecEventRecordNodeSetEvent(
                    exe, node, ctypes.c_void_p(ev.cuda_event)):
                raise RuntimeError("cuGraphExecEventRecordNodeSetEvent "
                                   "failed")
        self._pointed = events is not self._fixed

    def _event_set(self):
        """A set of timing events for one replay's marks, from the pool
        (each recorded once, so that it exists)."""
        if self._free:
            return self._free.pop()
        events = [torch.cuda.Event(enable_timing=True) for _ in self._nodes]
        for ev in events:
            ev.record()
        return events

    def replay(self):
        global replays
        with profiling.span("program.replay") as sp, \
                torch.cuda.device(self.device):
            events = None
            if self.stages:
                if sp is not None:
                    if profiling.pending() > 64:
                        profiling.resolve()
                    events = self._event_set()
                    self._point(events)
                elif self._pointed:
                    self._point(self._fixed)
            t0 = time.perf_counter_ns()
            self.graph.replay()
            if events is not None:
                profiling.add_device_stages(t0, sp.req, self.stages, events,
                                            self._free.append)
            counts = launch_counts.read()
            launch_counts.write({k: counts[k] + n
                                 for k, n in self.launches.items()})
            replays += 1
        return self.outputs
