"""Batched small-matrix exponential: the wrapper of the CUDA kernel
csrc/expm_small.cu, its launch plan and its plain PyTorch version.

The kernel replaces mpc4quantum_tpu/ops/pallas_expm.py::_expm_kernel
(`expm_pallas` there) and takes what that kernel takes: any d, complex
or real input. The instance depends on d (`expm_small_plan`):
- d 2-8: a team of 2-8 threads a matrix, X in each thread's registers;
- d 1 and 9-TILE_MAX_D: one block a matrix, each thread a 2 x 2 tile of
  each product with its two rows of X in registers and P in shared
  memory, a template on d so the product's sum unrolls; bound by
  the chain of products and their barriers at small B, by float32
  throughput at large B;
- TILE_MAX_D < d <= SMEM_MAX_D: one thread-block cluster a matrix (c CTAs,
  the least that fits, raised to 132 / B at small B, at most 8), CTA k a
  row panel of each product, P copied into every CTA through distributed
  shared memory, one cluster barrier a product;
- SMEM_MAX_D < d <= WIDE_MAX_D (cluster2d): P cut into g x g tiles of side
  16 m, one cluster of g^2 CTAs (up to 16, a non-portable size) a matrix,
  each CTA keeping its tiles of X, X^2, X^3 and P in shared memory and
  summing each product's k-panels from their owners through distributed
  shared memory, an m x m block of the tile a thread in registers; the
  Taylor polynomial by Paterson-Stockmeyer in blocks of 3 (5 products at
  taylor_k 12, where Horner takes 12);
- above WIDE_MAX_D (grid2d): the same tiles of side 64 on a workspace in
  device memory that this wrapper allocates, one cooperative launch over
  the batch's tiles with a grid barrier a product.
A real float32 batch is run as complex64 and its real part returned,
which is exact: the exponential of a real matrix is real. On a CPU tensor
the wrapper runs the plain version; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.expm import expm_taylor
from . import _build

# the largest d of the tile instance, of the cluster instance (the last
# whose CTA holds two copies of P and a panel of X, 8 stride (2 d +
# ceil(d / c)) bytes, at c <= 8) and of the cluster2d instance (4 x 4 tiles
# of 64); above it the tiles sit in a workspace (kTileMaxD, kClusterMaxD,
# kWideMaxD in csrc/expm_small.cu)
TILE_MAX_D = 32
SMEM_MAX_D = 116
WIDE_MAX_D = 256
# the instances in the order of mpc4q_expm_small_plan's ids
INSTANCES = ("team", "tile", "cluster", "cluster2d", "grid2d")
MAX_CLUSTER, MAX_SMEM, SMS = 8, 232448, 132
# the 2D-tile instances: tiles a side at most (kWideSide: a cluster of 16),
# threads a block, the largest m (tiles of side 16 m)
WIDE_SIDE, WIDE_THREADS, WIDE_MAX_M = 4, 256, 4


class Plan(NamedTuple):
    """How a call runs: the instance, its cluster size (1 outside the
    cluster instance), threads a block and dynamic shared bytes a block."""
    instance: str
    cluster: int
    threads: int
    smem: int


def _cluster_smem(d: int, c: int) -> int:
    return 8 * ((d + 1) // 2 * 2) * (2 * d + -(-d // c))


def _cluster_size(B: int, d: int) -> int:
    """cluster_size in csrc/expm_small.cu: the least c that fits, raised to
    fill the SMs at small B (at most 8), lowered while the last CTA would
    get no rows."""
    c = 1
    while c < MAX_CLUSTER and _cluster_smem(d, c) > MAX_SMEM:
        c += 1
    fill = 1 if B >= SMS else SMS // B
    if fill > c:
        c = min(fill, MAX_CLUSTER)
    while c > 1 and (c - 1) * -(-d // c) >= d and _cluster_smem(d, c - 1) <= MAX_SMEM:
        c -= 1
    return c


def _wide_m(d: int) -> int:
    """wide_m in csrc/expm_small.cu: the least m in 2..4 whose tiles of
    side 16 m cover d with at most WIDE_SIDE a side."""
    m = 2
    while m < WIDE_MAX_M and -(-d // (16 * m)) > WIDE_SIDE:
        m += 1
    return m


def _wide_smem(m: int, grid: bool) -> int:
    """The CTA's own tiles of X, X^2, X^3 and P twice (cluster2d only) and
    the two staged k-panels, the left one's rows padded by one entry."""
    T = 16 * m
    return 8 * ((0 if grid else 5 * T * T) + T * (T + 1) + T * T)


def grid2d_ws_floats(B: int, d: int) -> int:
    """The grid2d instance's workspace in floats, laid out as
    expm_wide_kernel in csrc/expm_small.cu reads it: per matrix X, X^2, X^3
    and P twice on the padded side G = 64 ceil(d / 64), G ceil(d / 64)
    partial column sums and the squaring count."""
    g = -(-d // (16 * WIDE_MAX_M))
    G = 16 * WIDE_MAX_M * g
    return B * (10 * G * G + g * G + 1)


def expm_small_plan(B: int, d: int) -> Plan:
    """The launch plan of an `expm_small` call at batch B and size d, as the
    kernel library computes it (mpc4q_expm_small_plan)."""
    if B < 1 or d < 1:
        raise ValueError(f"expm_small_plan: B={B}, d={d}")
    if 2 <= d <= 8:
        # the largest of 128, 64, 32 threads that gives two blocks an SM
        threads, block = B * (2 if d <= 2 else 4 if d <= 4 else 8), 128
        while block > 32 and -(-threads // block) < 2 * SMS:
            block //= 2
        return Plan("team", 1, block, 0)
    if d <= TILE_MAX_D:
        # 2 x 2 tiles, P's rows padded to whole tiles
        stride = (d + 1) // 2 * 2
        return Plan("tile", 1, ((d + 1) // 2 * (stride // 2) + 31) // 32 * 32,
                    16 * d * stride + 16)
    if d <= SMEM_MAX_D:
        c = _cluster_size(B, d)
        tiles = (-(-d // c) + 1) // 2 * ((d + 1) // 2)
        return Plan("cluster", c, min(1024, (tiles + 31) // 32 * 32), _cluster_smem(d, c))
    if d <= WIDE_MAX_D:
        m = _wide_m(d)
        return Plan("cluster2d", (-(-d // (16 * m))) ** 2, WIDE_THREADS, _wide_smem(m, False))
    return Plan("grid2d", 1, WIDE_THREADS, _wide_smem(WIDE_MAX_M, True))


def taylor_products(taylor_k: int) -> int:
    """The least matrix products that evaluate a Taylor polynomial of degree
    taylor_k by Paterson-Stockmeyer: X^2 .. X^p, then Horner in X^p over
    blocks of degree up to p, p - 1 + ceil(k / p) - 1 products at the best
    p (5 at 12, where Horner takes 12; 0 at degree 1)."""
    return min(p + -(-taylor_k // p) - 2 for p in range(1, max(taylor_k, 1) + 1))


def expm_small_work(B: int, d: int, taylor_k: int, squarings: int = 0):
    """The work of one `expm_small` call, counted from its shapes: per
    matrix the least products of its Taylor polynomial (`taylor_products`,
    8d^3 flops each: a complex FMA is 8 flops), 2d^2 flops a coefficient,
    and 16 d^2 bytes (complex64 in and out), plus 8d^3 flops for each of the
    `squarings` the call's matrices take in all (0 at max_squarings = 0).
    The norm and the scaling are not counted. It counts the function's
    work, not the kernel's design: the Horner instances' extra products,
    the team's threads each reading all of X, the shuffles of a squaring, a
    cluster's copies of P, add nothing to it.

    :return: (flops, bytes).
    """
    taylor = taylor_products(taylor_k) * 8 * d ** 3 + taylor_k * 2 * d * d
    return B * taylor + squarings * 8 * d ** 3, 16 * d * d * B


def expm_small_ref(A: torch.Tensor, taylor_k: int = 18, max_squarings: int = 12) -> torch.Tensor:
    """Plain version of the kernel: ops/expm.expm_taylor in the same form -
    no scaling or squaring at max_squarings = 0, else per-matrix squarings up
    to max_squarings.

    :raises ValueError: at max_squarings = 0 when some ||A||_1 > 1, which
        breaks the caller's certificate (the kernel does not check it).
    """
    if max_squarings == 0 and bool((A.abs().sum(dim=-2).amax(dim=-1) > 1.0).any()):
        raise ValueError("expm_small: max_squarings = 0 needs ||A||_1 <= 1 for every matrix")
    return expm_taylor(A, order=taylor_k, max_squarings=max_squarings,
                       fixed_squarings=0 if max_squarings == 0 else None)


def check_expm_args(shape, dtype, taylor_k: int, max_squarings: int) -> tuple[int, int]:
    """What the kernel takes, from the call's shape, dtype and budget: a
    batch (B, d, d) of any d >= 1 in complex64 or float32, taylor_k >= 1,
    max_squarings >= 0. :return: (B, d). :raises ValueError: otherwise."""
    if (dtype not in (torch.complex64, torch.float32) or len(shape) != 3
            or shape[1] != shape[2] or shape[1] < 1):
        raise ValueError(f"expm_small: A must be complex64 or float32 (B, d, d) with d >= 1, "
                         f"got {dtype} {tuple(shape)}")
    if taylor_k < 1 or max_squarings < 0:
        raise ValueError(f"expm_small: taylor_k={taylor_k}, max_squarings={max_squarings}")
    return int(shape[0]), int(shape[1])


def expm_small(A: torch.Tensor, taylor_k: int = 18, max_squarings: int = 12) -> torch.Tensor:
    """exp(A) for a batch A of shape (B, d, d), any d: complex64 or real
    float32 on the card (a real batch comes back real), any dtype on the CPU.

    :param taylor_k: Horner Taylor degree; 18 ~ 1e-15 truncation at
        ||A/2^s||_1 <= 1, 12 ~ 9e-12 at <= 0.8.
    :param max_squarings: bound on the per-matrix squaring count; 0 = the
        caller certifies ||A||_1 <= 1 and the kernel skips the norm, the
        scaling and the squaring.
    """
    if A.device.type == "cpu":
        return expm_small_ref(A, taylor_k, max_squarings)
    if A.device.type != "cuda":
        raise ValueError(f"expm_small: unsupported device {A.device}")
    B, d = check_expm_args(A.shape, A.dtype, taylor_k, max_squarings)
    real = A.dtype == torch.float32
    # the kernel reads the caller's row-major layout: a copy only for a
    # strided or conjugated view, or one not 16-byte aligned (the kernel
    # reads a matrix of even d as float4s), and for real input
    A = (A.to(torch.complex64) if real else A.resolve_conj()).contiguous()
    if A.data_ptr() % 16:
        A = A.clone()
    out = torch.empty((B, d, d), dtype=torch.complex64, device=A.device)
    ws = (torch.empty(grid2d_ws_floats(B, d), dtype=torch.float32, device=A.device)
          if d > WIDE_MAX_D else None)
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.mpc4q_expm_small(A.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                              B, d, int(taylor_k), int(max_squarings), stream)
    _build.check(rc, "expm_small")
    expm_small.launches += 1
    return out.real.contiguous() if real else out


expm_small.launches = 0
