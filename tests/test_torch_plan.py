"""The launch plans of the two kernels whose instance depends on size, on
the CPU: kernels/admm_big.py::admm_big_plan and kernels/expm.py::
expm_small_plan, which compute what the kernel library's
mpc4q_admm_big_plan and mpc4q_expm_small_plan compute (chip_smoke.py holds
the two equal on the card for every n in 1..4096 and d in 1..160, and each
checked call's captured launch to its plan).

Every size gets exactly one instance, within what a CTA of an H100 may
have (227 KB of shared memory, 1024 threads, whole warps) and a cluster of
at most 16 CTAs (above the portable 8 only where a source opts into a
non-portable size); the instances change where the sources' own constants
say, and the Python mirrors read their constants back from the sources; a
cluster leaves no CTA without rows; and the work counts (`*_work`) are the
function's, whatever instance runs it.
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
        assert 1 <= plan.cluster <= admm_mod.MAX_CLUSTER == 16
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert 0 <= plan.smem <= MAX_SMEM
        clustered = plan.instance in ("cluster", "stream", "stream_ws")
        assert (plan.cluster > 1) == clustered
        if clustered:
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
        assert 1 <= plan.cluster <= expm_mod.WIDE_SIDE ** 2 == 16
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert 0 <= plan.smem <= MAX_SMEM
        if plan.instance == "cluster2d":
            # g x g tiles of side 16 m cover d, and no row of tiles is empty
            m, g = expm_mod._wide_m(d), round(plan.cluster ** 0.5)
            assert g * g == plan.cluster and 2 <= g <= expm_mod.WIDE_SIDE
            assert (g - 1) * 16 * m < d <= g * 16 * m
            assert plan.smem == expm_mod._wide_smem(m, False)
        elif plan.instance == "cluster":
            assert plan.cluster <= expm_mod.MAX_CLUSTER
            rows = -(-d // plan.cluster)
            assert (plan.cluster - 1) * rows < d
            # a cluster of more CTAs only where B leaves SMs idle
            if B >= expm_mod.SMS:
                assert plan.cluster == 1 or expm_mod._cluster_smem(d, plan.cluster - 1) > MAX_SMEM
        else:
            assert plan.cluster == 1
        seen.add(plan.instance)
    assert seen == set(expm_mod.INSTANCES) - {"grid2d"}


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
    (expm_mod.SMEM_MAX_D + 1, "cluster2d"), (expm_mod.WIDE_MAX_D, "cluster2d"),
    (expm_mod.WIDE_MAX_D + 1, "grid2d")])
def test_expm_boundaries(d, instance):
    """The instance changes at the constants of csrc/expm_small.cu
    (kTileMaxD, kClusterMaxD, kWideMaxD), which the module mirrors; the last
    d of the cluster instance is the last whose P, twice, and a panel of X
    fit a CTA of a cluster of 8; the last d of the cluster2d instance the
    last that 4 x 4 tiles of 64 cover, whose CTA's three tiles and two
    staged panels fit."""
    assert expm_mod.TILE_MAX_D == source_constant("expm_small.cu", "kTileMaxD")
    assert expm_mod.SMEM_MAX_D == source_constant("expm_small.cu", "kClusterMaxD")
    assert expm_mod.WIDE_MAX_D == source_constant("expm_small.cu", "kWideMaxD")
    assert expm_mod._cluster_smem(expm_mod.SMEM_MAX_D, 8) <= MAX_SMEM
    assert expm_mod._cluster_smem(expm_mod.SMEM_MAX_D + 1, 8) > MAX_SMEM
    assert expm_mod.WIDE_MAX_D == expm_mod.WIDE_SIDE * 16 * expm_mod.WIDE_MAX_M
    assert expm_mod._wide_smem(expm_mod.WIDE_MAX_M, False) <= MAX_SMEM
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
                                               (417, 3, 288), (512, 4, 256), (736, 8, 192),
                                               (737, 10, 160), (750, 10, 160), (1008, 16, 128)])
def test_admm_cluster_sizes(n, cluster, threads):
    """At cnot_h80's n 240 a cluster of 2 CTAs of 256 threads: two CTAs
    share an SM (their threads, registers at 128 a thread and shared
    memory fit), so B 128 runs its 256 CTAs in one wave on 132 SMs. Above
    n 736 no cluster of 8 fits (a CTA would need more than 227 KB): at
    cnot_h250's n 750 a cluster of 10, at the largest n, 1008, one of 16."""
    plan = admm_mod.admm_big_plan(128, n)
    assert (plan.instance, plan.cluster, plan.threads) == ("cluster", cluster, threads)
    if n == 240:
        assert 2 * plan.threads * 128 <= 65536 and 2 * (plan.smem + 1024) <= 233472


@pytest.mark.parametrize("n", [20, 239, 240, 241, 512, 736, 737, 750, 1008, 1009, 1024, 4096])
@pytest.mark.parametrize("B,iters", [(1, 10), (128, 300)])
def test_admm_work_is_the_functions(n, B, iters):
    """K^-1, q, lb, ub, x, z, y and rho read once, x, z, y written once,
    2 n^2 + 8 n flops an iteration a lane, whatever the instance."""
    assert admm_mod.admm_big_work(B, n, iters) == (B * iters * (2 * n * n + 8 * n),
                                                   4 * B * (n * n + 9 * n + 1))


@pytest.mark.parametrize("d", [1, 2, 8, 9, 16, 32, 33, 100, 116, 117, 256, 300])
@pytest.mark.parametrize("B,taylor_k,squarings", [(4, 12, 3), (1024, 12, 0)])
def test_expm_work_is_the_functions(d, B, taylor_k, squarings):
    """The Taylor polynomial's least products (5 at taylor_k 12, by
    Paterson-Stockmeyer) and the squarings' products, complex64 in and
    out, whatever the instance."""
    assert expm_mod.expm_small_work(B, d, taylor_k, squarings) == (
        B * (5 * 8 * d ** 3 + taylor_k * 2 * d * d) + squarings * 8 * d ** 3, 16 * d * d * B)


@pytest.mark.parametrize("d,cluster,side", [(117, 16, 32), (128, 16, 32), (129, 9, 48),
                                            (144, 9, 48), (145, 16, 48), (192, 16, 48),
                                            (193, 16, 64), (256, 16, 64)])
def test_expm_cluster2d_tiles(d, cluster, side):
    """Above d 116 one cluster a matrix at any B: g x g CTAs of 256 threads,
    tiles of side 16 m, m the least in 2..4 that covers d in at most 4
    tiles a side; a CTA holds its tiles of X, X^2, X^3 and P twice and the
    two staged panels (damped_chain4's d 256: 16 CTAs, tiles of 64,
    224.5 KB)."""
    for B in (1, 4, 128, 16384):
        plan = expm_mod.expm_small_plan(B, d)
        assert (plan.instance, plan.cluster, plan.threads) == ("cluster2d", cluster, 256)
        assert plan.smem == 8 * (5 * side * side + side * (side + 1) + side * side)


@pytest.mark.parametrize("d", [257, 300, 1024])
def test_expm_grid2d_plan_and_workspace(d):
    """Above d 256 the tiles of side 64 sit in a workspace: per matrix X,
    X^2, X^3 and P twice on the padded side, the norm's partial sums, the
    squaring count; no cluster, the two staged panels in shared memory."""
    g = -(-d // 64)
    for B in (1, 2, 128):
        assert expm_mod.expm_small_plan(B, d) == ("grid2d", 1, 256, 8 * (64 * 65 + 64 * 64))
        assert expm_mod.grid2d_ws_floats(B, d) == B * (10 * (64 * g) ** 2 + g * 64 * g + 1)


@pytest.mark.parametrize("n,smem", [(1009, 16 + 8 * 1009), (4096, 16 + 8 * 4096),
                                    (admm_mod.STREAM_SMEM_MAX_N, MAX_SMEM),
                                    (admm_mod.STREAM_SMEM_MAX_N + 1, 0)])
def test_admm_stream_plans(n, smem):
    """Above the cluster instance a cluster of 16 CTAs a lane streams K^-1:
    each CTA's copy of the two rhs buffers and their mbarriers in shared
    memory up to STREAM_SMEM_MAX_N (the 227 KB a CTA may have), none above
    (the workspace)."""
    for B in (1, 16):
        plan = admm_mod.admm_big_plan(B, n)
        assert plan.cluster == admm_mod.STREAM_CLUSTER == 16
        assert plan.threads == 512 and plan.smem == smem


@pytest.mark.parametrize("source,name,value", [
    ("admm_big.cu", "kMaxCluster", admm_mod.MAX_CLUSTER),
    ("admm_big.cu", "kStreamCluster", admm_mod.STREAM_CLUSTER),
    ("admm_big.cu", "kStreamThreads", admm_mod._STREAM_THREADS),
    ("admm_big.cu", "kClusterMaxThreads", admm_mod._CLUSTER_THREADS),
    ("admm_big.cu", "kClusterC", admm_mod._CLUSTER_C),
    ("expm_small.cu", "kWideSide", expm_mod.WIDE_SIDE),
    ("expm_small.cu", "kWideThreads", expm_mod.WIDE_THREADS),
    ("expm_small.cu", "kWideMaxM", expm_mod.WIDE_MAX_M),
    ("expm_small.cu", "kMaxCluster", expm_mod.MAX_CLUSTER),
    ("expm_small.cu", "kMaxSmem", expm_mod.MAX_SMEM)])
def test_plan_constants_are_the_sources(source, name, value):
    """The Python plans mirror the C plans' constants (chip_smoke.py holds
    the two plans equal on the card)."""
    assert source_constant(source, name) == value


@pytest.mark.parametrize("plan", [admm_mod.admm_big_plan, expm_mod.expm_small_plan])
@pytest.mark.parametrize("B,size", [(0, 10), (4, 0), (-1, 5)])
def test_plans_refuse_empty_shapes(plan, B, size):
    with pytest.raises(ValueError):
        plan(B, size)
