"""What a call puts on the card, read from a CUDA graph captured from it."""

from __future__ import annotations

import ctypes

import torch


def graph_node_types(fn) -> list[int]:
    """The node types of a CUDA graph captured from one fn() after a
    warm-up call (CUgraphNodeType: 0 a kernel, 1 a copy, 2 a fill, ...),
    read through the driver API."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(graph.raw_cuda_graph(), ctypes.cast(nodes, ctypes.c_void_p),
                            ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(kind.value)
    return types
