"""The kernel nodes of a captured CUDA graph, by name, read through the
CUDA driver (``libcuda``) with ctypes.

A graph captured with ``torch.cuda.CUDAGraph(keep_graph=True)`` keeps its
``cudaGraph_t`` (``raw_cuda_graph()``) until it is destroyed; the runtime's
graph is the CUDA driver's ``CUgraph``.  Each kernel node names the function it
launches, so a replay launches exactly those kernels: a count that no
profiler can lose (``core.runtime.CapturedRound`` records them by family).

The driver, not ``libcudart``: the port's kernels are built by ``nvcc``
with its default static runtime, one copy a library, and a runtime maps a
node's function back to a host stub only for the kernels it registered
itself; the CUDA driver's handles and names are the same for every caller in
the process.  ``cuFuncGetName`` and ``cuKernelGetName`` need a driver of
CUDA 12.3 or later.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes

#: ``CU_GRAPH_NODE_TYPE_KERNEL`` (cuda.h).
_KERNEL_NODE = 0

_driver: ctypes.CDLL | None = None


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h, CUDA 12)."""

    _fields_ = [
        ("func", ctypes.c_void_p),
        ("grid", ctypes.c_uint * 3),
        ("block", ctypes.c_uint * 3),
        ("shared_mem_bytes", ctypes.c_uint),
        ("kernel_params", ctypes.c_void_p),
        ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p),
        ("ctx", ctypes.c_void_p),
    ]


def _lib() -> ctypes.CDLL:
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
        name_p = ctypes.POINTER(ctypes.c_char_p)
        for fn, args in (
                ("cuGraphGetNodes", (p, ctypes.POINTER(p), size_p)),
                ("cuGraphNodeGetType", (p, ctypes.POINTER(ctypes.c_int))),
                ("cuGraphKernelNodeGetParams_v2",
                 (p, ctypes.POINTER(_KernelNodeParams))),
                ("cuFuncGetName", (name_p, p)),
                ("cuKernelGetName", (name_p, p))):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _driver = lib
    return _driver


def _check(status: int, call: str) -> None:
    if status != 0:
        raise RuntimeError(f"{call} failed with CUresult {status}")


def _name(lib: ctypes.CDLL, params: _KernelNodeParams) -> str:
    out = ctypes.c_char_p()
    if params.func and lib.cuFuncGetName(ctypes.byref(out), params.func) == 0:
        return out.value.decode()
    _check(lib.cuKernelGetName(ctypes.byref(out), params.kern),
           "cuKernelGetName")
    return out.value.decode()


def kernel_nodes(raw_graph: int) -> dict[str, int]:
    """The kernel nodes of a ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``
    of a graph kept after its capture), counted by kernel name (mangled,
    as the driver gives it)."""
    lib = _lib()
    graph = ctypes.c_void_p(raw_graph)
    count = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(count)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(count)),
           "cuGraphGetNodes")
    names: dict[str, int] = {}
    kind = ctypes.c_int()
    for node in nodes[:count.value]:
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        _check(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        name = _name(lib, params)
        names[name] = names.get(name, 0) + 1
    return names
