"""What a call puts on the card, read from a CUDA graph captured from it."""

from __future__ import annotations

import ctypes
import functools

import torch


# CUlaunchAttributeID of a kernel node's cluster dimensions
_CLUSTER_DIMENSION = 4


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.lru_cache(maxsize=1)
def _libcuda():
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    return cuda


def node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a graph captured with keep_graph=True."""
    count = ctypes.c_size_t(0)
    if _libcuda().cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    return count.value


def _capture(fn):
    """A CUDA graph captured from one fn() after a warm-up call, and its
    nodes, read through libcuda's graph calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = _libcuda()
    count = ctypes.c_size_t(node_count(graph))
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(graph.raw_cuda_graph(), ctypes.cast(nodes, ctypes.c_void_p),
                            ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    return cuda, graph, list(nodes)


def graph_node_types(fn) -> list[int]:
    """The node types of a CUDA graph captured from one fn() after a
    warm-up call (CUgraphNodeType: 0 a kernel, 1 a copy, 2 a fill, ...)."""
    cuda, _graph, nodes = _capture(fn)
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(kind.value)
    return types


def graph_kernel_launches(fn) -> list[dict]:
    """How each kernel of one fn() was launched, read from the kernel nodes
    of a CUDA graph captured from it: grid and block sizes, dynamic shared
    bytes and cluster dimensions (1, 1, 1 for a launch without a cluster)."""
    cuda, _graph, nodes = _capture(fn)
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p,
                                                   ctypes.POINTER(_KernelNodeParams)]
    cuda.cuGraphKernelNodeGetAttribute.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                                   ctypes.c_void_p]
    launches = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0 or kind.value != 0:
            continue
        params = _KernelNodeParams()
        if cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)) != 0:
            raise RuntimeError("cuGraphKernelNodeGetParams failed")
        value = (ctypes.c_uint * 16)()  # CUlaunchAttributeValue, 64 bytes
        if cuda.cuGraphKernelNodeGetAttribute(node, _CLUSTER_DIMENSION, value) != 0:
            raise RuntimeError("cuGraphKernelNodeGetAttribute failed")
        launches.append({"grid": tuple(params.grid), "block": tuple(params.block),
                         "smem": params.shared,
                         "cluster": tuple(max(1, int(v)) for v in value[:3])})
    return launches
