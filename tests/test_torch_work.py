"""Where the port's entry points put their tensors, and the kernels' work
counts. No JAX: the presets are built on the CPU only where the test asks
for it, and the work counts are held against counts made by hand.
"""

import inspect

import pytest
import torch

from mpc4quantum_tpu_torch import convert, presets
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big_work
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small_work
from mpc4quantum_tpu_torch.kernels.expm import expm_small_work, taylor_products
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

ENTRY_POINTS = [*presets.PRESETS.values(), presets.scenario_from_arrays,
                convert.scenario_from_numpy]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda fn: fn.__name__)
def test_entry_points_default_to_the_card(fn):
    params = inspect.signature(fn).parameters
    assert params["device"].default == "cuda"
    assert params["dtype"].default is None


def test_default_dtype_resolves_by_device():
    assert presets.default_dtype("cuda") == torch.float32
    assert presets.default_dtype(torch.device("cuda", 0)) == torch.float32
    assert presets.default_dtype("cpu") == torch.float64
    assert presets.default_dtype("cpu", torch.float32) == torch.float32
    assert presets.default_dtype("cuda", torch.float64) == torch.float64
    sc = presets.not_state(device="cpu")
    assert sc.x0.device.type == "cpu" and sc.plant.real_dtype == torch.float64
    assert sc.x0.dtype == torch.complex128


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_preset_without_device_lands_on_the_card_or_raises(name):
    """Built with no device, a preset is on the card in float32; where there
    is no card it raises, and nothing quietly runs on the CPU."""
    if torch.cuda.is_available():
        sc = presets.PRESETS[name]()
        assert sc.x0.device.type == "cuda" and sc.plant.device.type == "cuda"
        assert sc.plant.real_dtype == torch.float32 and sc.x0.dtype == torch.complex64
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            presets.PRESETS[name]()


def test_scenario_batch_follows_the_base_plant():
    base = presets.lindblad_state(device="cpu", dtype=torch.float32).plant
    lanes = make_scenario_batch(base, 4)
    assert lanes.device.type == "cpu" and lanes.real_dtype == torch.float32
    wide = make_scenario_batch(base, 4, dtype=torch.float64)
    assert wide.real_dtype == torch.float64
    torch.testing.assert_close(lanes.AH0.to(torch.complex128), wide.AH0, rtol=0, atol=1e-6)


# hand counts: (arguments, keywords, flops, bytes)
BOXQP_WORK = [
    # n = 3, 2 rounds of 4: 2 (54 + 4 (18 + 24) + 18 + 36) = 552 flops a lane;
    # 4 (9 + 21 + 9) = 156 bytes a lane with every warm start
    ((2, 3, 4, 2), {}, 1104, 312),
    # the same cold: no x0, y0, rho0 -> 4 (9 + 15 + 8) = 128 bytes a lane
    ((2, 3, 4, 2), dict(x0=False, y0=False, rho0=False), 1104, 256),
    # the flagship's cold 3 x 12 at n = 10: 3 (2000 + 12 * 280 + 200 + 120)
    # = 17040 flops and 4 * 179 = 716 bytes a lane
    ((16384, 10, 12, 3), {}, 17040 * 16384, 716 * 16384),
    # not_gate's n = 15: 3 (6750 + 12 * 570 + 450 + 180) = 42660 flops,
    # 4 * 339 = 1356 bytes a lane
    ((1024, 15, 12, 3), {}, 42660 * 1024, 1356 * 1024),
]


@pytest.mark.parametrize("args,kw,flops,nbytes", BOXQP_WORK)
def test_boxqp_small_work_matches_hand_count(args, kw, flops, nbytes):
    assert boxqp_small_work(*args, **kw) == (flops, nbytes)


@pytest.mark.parametrize("args,flops,nbytes", [
    # n = 5, 2 iterations: 2 (50 + 40) = 180 flops, 4 (25 + 45 + 1) = 284 bytes a lane
    ((3, 5, 2), 3 * 180, 3 * 284),
    # freq's n = 50, 40 iterations: 40 * 5400 flops, 4 * 2951 bytes a lane
    ((1024, 50, 40), 1024 * 216000, 1024 * 11804),
])
def test_admm_big_work_matches_hand_count(args, flops, nbytes):
    assert admm_big_work(*args) == (flops, nbytes)


@pytest.mark.parametrize("args,flops,nbytes", [
    # d = 2, Taylor 12 in 5 products (Paterson-Stockmeyer), no squaring:
    # 5 * 64 + 12 * 8 = 416 flops, 64 bytes a matrix
    ((5, 2, 12), 5 * 416, 5 * 64),
    # d = 3, Taylor 12, 3 squarings in all: 2 (5 * 216 + 12 * 18) + 3 * 216 flops
    ((2, 3, 12, 3), 2 * 1296 + 3 * 216, 2 * 144),
])
def test_expm_small_work_matches_hand_count(args, flops, nbytes):
    assert expm_small_work(*args) == (flops, nbytes)


@pytest.mark.parametrize("taylor_k,products", [(1, 0), (2, 1), (3, 2), (4, 2), (6, 3), (12, 5),
                                               (18, 7)])
def test_taylor_products_are_paterson_stockmeyers(taylor_k, products):
    """min over p of p - 1 + ceil(k / p) - 1: at 12, X^2 and X^3 and three
    Horner steps in X^3 (the top coefficient times X^3 needs no product)."""
    assert taylor_products(taylor_k) == products
