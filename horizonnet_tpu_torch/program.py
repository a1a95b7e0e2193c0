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
"""

import ctypes

import numpy as np
import torch

from .ops import launch_counts

#: Eager runs of a program before its capture (CapturedProgram).
WARMUP = 2

#: CUgraphNodeType of a kernel node (the driver API's
#: CU_GRAPH_NODE_TYPE_KERNEL)
_KERNEL_NODE = 0


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
        if self._cuda:
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


def graph_nodes(graph):
    """(nodes, kernel nodes) of a captured ``torch.cuda.CUDAGraph`` made
    with ``keep_graph=True``, read through the driver API."""
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    kind = ctypes.c_int(0)
    for i in range(n.value):
        if cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                 ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == _KERNEL_NODE
    return n.value, kernels


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
    replay adds the captured launches, kernel by kernel. A capture that
    fails, or that recorded less than the wrappers launched
    (``check_capture``), raises: there is no eager fallback.
    """

    def __init__(self, fn, device, warmup=WARMUP, keep=(), generator=None):
        self.device = torch.device(device)
        keep = list(keep)
        with torch.cuda.device(self.device):
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
            try:
                with torch.cuda.graph(self.graph, stream=side):
                    self.outputs = fn()
            finally:
                after = launch_counts.read()
                launch_counts.write(before)
            #: {(module, count): launches in one replay} of the wrappers
            #: that the program runs
            self.launches = {k: n - before.get(k, 0)
                             for k, n in after.items()
                             if n != before.get(k, 0)}
            check_capture(*graph_nodes(self.graph),
                          sum(self.launches.values()))
            self.graph.instantiate()

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        counts = launch_counts.read()
        launch_counts.write({k: counts[k] + n
                             for k, n in self.launches.items()})
        return self.outputs
