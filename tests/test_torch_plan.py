"""The launch plans of the two kernels whose instance depends on size, on
the CPU: kernels/admm_big.py::admm_big_plan and kernels/expm.py::
expm_small_plan, which compute what the kernel library's
mpc4q_admm_big_plan and mpc4q_expm_small_plan compute (chip_smoke.py holds
the two equal on the card for every n in 1..4096 and d in 1..160, and each
checked call's captured launch to its plan).

Every size gets exactly one instance, within what a CTA of an H100 may
have (227 KB of shared memory, 1024 threads, whole warps) and a portable
cluster (at most 8 CTAs); the instances change where the sources' own
constants say; a cluster leaves no CTA without rows; and the work counts
(`*_work`) are the function's, whatever instance runs it.
"""

import re
from pathlib import Path

import pytest

from mpc4quantum_tpu_torch.kernels import admm_big as admm_mod
from mpc4quantum_tpu_torch.kernels import expm as expm_mod

CSRC = Path(admm_mod.__file__).resolve().parent.parent / "csrc"
MAX_SMEM = 232448
BATCHES = [1, 4, 16, 128, 1024, 16384]


def source_constant(source: str, name: str) -> int:
    """`constexpr int <name> = <value>;` of csrc/<source>."""
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, f"{name} not in {source}"
    return int(eval(m.group(1), {}))  # a literal or a product of literals


@pytest.mark.parametrize("B", BATCHES)
def test_every_n_has_one_admm_instance_that_fits(B):
    seen = set()
    for n in range(1, 4097):
        plan = admm_mod.admm_big_plan(B, n)
        assert plan.instance in admm_mod.INSTANCES
        assert 1 <= plan.cluster <= admm_mod.MAX_CLUSTER
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert 0 <= plan.smem <= MAX_SMEM
        assert (plan.cluster > 1) == (plan.instance == "cluster")
        if plan.instance == "cluster":
            # no CTA of the cluster is left without rows
            rows = -(-n // plan.cluster)
            assert (plan.cluster - 1) * rows < n
        seen.add(plan.instance)
    assert seen == set(admm_mod.INSTANCES) - {"stream_ws"}


@pytest.mark.parametrize("B", BATCHES)
def test_every_d_has_one_expm_instance_that_fits(B):
    seen = set()
    for d in range(1, 161):
        plan = expm_mod.expm_small_plan(B, d)
        assert plan.instance in expm_mod.INSTANCES
        assert 1 <= plan.cluster <= expm_mod.MAX_CLUSTER
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert 0 <= plan.smem <= MAX_SMEM
        if plan.instance == "cluster":
            rows = -(-d // plan.cluster)
            assert (plan.cluster - 1) * rows < d
            # a cluster of more CTAs only where B leaves SMs idle
            if B >= expm_mod.SMS:
                assert plan.cluster == 1 or expm_mod._cluster_smem(d, plan.cluster - 1) > MAX_SMEM
        else:
            assert plan.cluster == 1
        seen.add(plan.instance)
    assert seen == set(expm_mod.INSTANCES)


@pytest.mark.parametrize("n,instance", [
    (32, "reg32"), (33, "reg64"), (239, "reg239"), (240, "cluster"),
    (admm_mod.CLUSTER_MAX_N, "cluster"), (admm_mod.CLUSTER_MAX_N + 1, "stream"),
    (admm_mod.STREAM_SMEM_MAX_N, "stream"), (admm_mod.STREAM_SMEM_MAX_N + 1, "stream_ws")])
def test_admm_boundaries(n, instance):
    """The instance changes at the constants of csrc/admm_big.cu (kMaxN,
    kClusterMaxN, kStreamSmemMaxN), which the module mirrors."""
    assert admm_mod.REG_MAX_N == source_constant("admm_big.cu", "kMaxN") == 239
    assert admm_mod.CLUSTER_MAX_N == source_constant("admm_big.cu", "kClusterMaxN")
    assert admm_mod.STREAM_SMEM_MAX_N == source_constant("admm_big.cu", "kStreamSmemMaxN")
    for B in (1, 128):
        assert admm_mod.admm_big_plan(B, n).instance == instance


@pytest.mark.parametrize("d,instance", [
    (1, "tile"), (2, "team"), (8, "team"), (9, "tile"), (expm_mod.TILE_MAX_D, "tile"),
    (expm_mod.TILE_MAX_D + 1, "cluster"), (expm_mod.SMEM_MAX_D, "cluster"),
    (expm_mod.SMEM_MAX_D + 1, "workspace")])
def test_expm_boundaries(d, instance):
    """The instance changes at the constants of csrc/expm_small.cu
    (kTileMaxD, kClusterMaxD), which the module mirrors; the last d of the
    cluster instance is the last whose P, twice, and a panel of X fit a CTA
    of a cluster of 8."""
    assert expm_mod.TILE_MAX_D == source_constant("expm_small.cu", "kTileMaxD")
    assert expm_mod.SMEM_MAX_D == source_constant("expm_small.cu", "kClusterMaxD")
    assert expm_mod._cluster_smem(expm_mod.SMEM_MAX_D, 8) <= MAX_SMEM
    assert expm_mod._cluster_smem(expm_mod.SMEM_MAX_D + 1, 8) > MAX_SMEM
    for B in (1, 4, 1024):
        assert expm_mod.expm_small_plan(B, d).instance == instance


@pytest.mark.parametrize("B,d,cluster,threads", [
    (4, 100, 8, 352),      # d 100 at B 4: 4 clusters of 8 CTAs
    (16, 64, 8, 128),      # d 64 at B 16: 16 clusters of 8
    (128, 64, 1, 1024),    # enough matrices to fill the card: one CTA a matrix
    (1, 33, 7, 64),        # 8 CTAs would leave the last one without rows
    (16384, 116, 7, 544)])  # d 116 needs 7 CTAs to fit
def test_expm_cluster_sizes(B, d, cluster, threads):
    plan = expm_mod.expm_small_plan(B, d)
    assert (plan.instance, plan.cluster, plan.threads) == ("cluster", cluster, threads)


@pytest.mark.parametrize("n,cluster,threads", [(240, 2, 256), (241, 2, 256), (416, 2, 416),
                                               (417, 3, 288), (512, 4, 256), (736, 8, 192)])
def test_admm_cluster_sizes(n, cluster, threads):
    """At cnot_h80's n 240 a cluster of 2 CTAs of 256 threads: two CTAs
    share an SM (their threads, registers at 128 a thread and shared
    memory fit), so B 128 runs its 256 CTAs in one wave on 132 SMs."""
    plan = admm_mod.admm_big_plan(128, n)
    assert (plan.instance, plan.cluster, plan.threads) == ("cluster", cluster, threads)
    if n == 240:
        assert 2 * plan.threads * 128 <= 65536 and 2 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("n", [20, 239, 240, 241, 512, 736, 737, 1024])
@pytest.mark.parametrize("B,iters", [(1, 10), (128, 300)])
def test_admm_work_is_the_functions(n, B, iters):
    """K^-1, q, lb, ub, x, z, y and rho read once, x, z, y written once,
    2 n^2 + 8 n flops an iteration a lane, whatever the instance."""
    assert admm_mod.admm_big_work(B, n, iters) == (B * iters * (2 * n * n + 8 * n),
                                                   4 * B * (n * n + 9 * n + 1))


@pytest.mark.parametrize("d", [1, 2, 8, 9, 16, 32, 33, 100, 116, 117])
@pytest.mark.parametrize("B,taylor_k,squarings", [(4, 12, 3), (1024, 12, 0)])
def test_expm_work_is_the_functions(d, B, taylor_k, squarings):
    """taylor_k Horner products and the squarings' products, complex64 in
    and out, whatever the instance."""
    assert expm_mod.expm_small_work(B, d, taylor_k, squarings) == (
        B * taylor_k * (8 * d ** 3 + 2 * d * d) + squarings * 8 * d ** 3, 16 * d * d * B)


@pytest.mark.parametrize("plan", [admm_mod.admm_big_plan, expm_mod.expm_small_plan])
@pytest.mark.parametrize("B,size", [(0, 10), (4, 0), (-1, 5)])
def test_plans_refuse_empty_shapes(plan, B, size):
    with pytest.raises(ValueError):
        plan(B, size)
