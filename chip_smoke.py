#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of mpc4quantum_tpu_torch from the
checkout (ptxas must report no spills in the instances the fleets run) and
holds each against its plain PyTorch version at the shapes of the fleets
that run it: `boxqp_small` (unscaled and Jacobi-scaled) and `expm_small` at
d = 2 for the flagship, `boxqp_small` at n = 15 for `not_gate`,
`expm_small` at d = 4 on non-normal Liouvillians for `lindblad_state`,
`admm_big` (alone, up to n = 239, and inside the whole `boxqp_big` solve,
Gauss-Jordan and Newton-Schulz inverses) and `expm_small` at d = 3 for the
large-n presets, `expm_small` at d = 4 in its certified form on Hermitian
generators and `admm_big` at n = 40 and 150 for the two-qubit presets,
`expm_small` at d = 5 to 8 and `admm_big` at n = 24 for the 3-qubit
problem, and `condense_small` (the model phase of the small QPs: each
output against model_along_traj + qp_data, one kernel a call) at the
flagship's B 1, 16384 and 131072 and not_gate's B 1024. Each
kernel phase gives the wrapper's time (CUDA events),
the call's device time without the host's dispatch (a CUDA graph of 20
calls, replayed), the plain version's time, the bound - the larger of the
work's operations over the card's float32 peak and its bytes over the
memory rate - and for `expm_small` the time of `torch.linalg.matrix_exp`
on the same input; a `boxqp_small` solve must put exactly one kernel on
the card (the nodes of a CUDA graph captured from it), and so must an
`expm_small` call, which it also checks at B = 1024, the shape of
`not_gate` and `not_state_freq`. Beside every device time it prints the
launch floor: the replay of a graph of 20 dependent one-element in-place
adds, over 20, the least time a graph node takes on the card. Then it drives
seven fleets through `run_hostloop_fleet`, built with no device argument
(so on the card, in float32) - the flagship `not_state` (B = 16384),
`not_gate` (B = 1024, 90 steps, every lane exits early), `lindblad_state`
(B = 16384), `drag_state` (B = 2048), `not_state_freq` (B = 1024),
`crosstalk` (B = 1024, every step a warm solve) and `cnot_state` (B = 128,
order 2, lanes under 0.99 re-run at order 3) - checks their quality gates
and their kernel launch counts, and holds each fleet's first lanes against
the float64 plain path on the CPU; then `bench_entry` runs the benchmark
entry, bench_torch.main() at its defaults (the flagship at B = 16384 and
the six presets), in the same process, with its gates and each kernel's
launches against the runners' budgets; a short cnot run in which every
lane is marginal drives the rescue pass on the card. Then the learned-model and
single-rollout phases, and the command line (`python -m
mpc4quantum_tpu_torch`): one rollout on the adaptive Cholesky QP, the LQR
rollout, `--batch 1024`, the flagship fleet through `--hostloop` with
checkpoints plus a crashed and resumed run, and `solve_boxqp` alone. The
K-inverse family and the real-state path: the four K^-1 forms (Newton-
Schulz, Gauss-Jordan, Riccati, its scan) timed at the large-n fleets'
shapes, cnot and freq under the Riccati inverses, freq and drag with the
steady K-inverse carry, the Van der Pol Koopman MPC (mpc() on both QP
routes, batched_mpc at B 1024) and the flagship in its real embedding
against the complex problem. Last, the multi-device layer on a real NCCL
group of one rank (the machine has one card): tp_3q, the JAX package's
3-qubit tensor-parallel problem (dim_x 64; expm_small at d 8, admm_big at
n 24) at B 1024, dense and through tp_model_fns, and sharded_fleet, the
flagship at B 16384 through sharded_mpc against batched_mpc, with the
collectives counted and timed, and graft_entry_torch.py: entry()'s one
flagship MPC step on the card against float64 on the CPU, and
dryrun_multichip(1), the sharded tiny rollout on a one-rank NCCL group.
The kernels' other sizes are checked too: `expm_small` at d 9 to 32 (the
tile instance, one block a matrix), 64 to 116 (the cluster instance, one
thread-block cluster a matrix), 117 to 256 (the cluster2d instance, a
cluster of up to 16 CTAs a matrix, a 2D tile each) and 300 (the grid2d
instance, one cooperative launch over a workspace), NaN matrices at d 16,
100, 256 and 300 and a real float32 batch, `admm_big` at n 240 to 1008 (the
cluster instance, one cluster of up to 16 CTAs a lane), 1009 to 4096 (the
streaming instance, a cluster of 16 CTAs a lane) and 29,057 (its workspace
form); every launch plan of the two kernels as the kernel library
computes it against the Python one (d 1-160, n 1-4096), and each checked
call's kernel node in a captured CUDA graph against its plan (block,
shared bytes, cluster dimensions); the redesigned instances against the
first ones' device times and, at d 100, 117 and 128, torch.linalg.matrix_exp;
and four scenarios of no preset, built from the port's constructors, run
through `run_hostloop_fleet` as the JAX package runs any Scenario:
damped_pair (cnot_state's pair with amplitude damping, a 16 x 16
Liouvillian plant step) and cnot_h80 (cnot_state at horizon 80, QP n 240)
at B 128, damped_chain4 (four damped qubits, a 256 x 256 Liouvillian plant
step) at B 128 and cnot_h250 (horizon 250, QP n 750) at B 16, with their
gates, launch counts and lanes against float64 on the CPU. One
JSON line per phase; then the card's name and power limit, the per-kernel
record, and last {"ok": true, "device": {...}}. Any failure raises and
exits non-zero. Without a CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --kernels            # build, plans and kernel phases only
    python3 chip_smoke.py --time-kernels ROOT  # device times, ROOT's package
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed

DEVICE = "cuda"
T_START = time.perf_counter()
BATCH = 16384
EXPM_D = 2
QP_TOL = 1e-3              # max |z|, |y| difference, relative to max(1, |ref|), float32
# relative rho difference: a rebalance multiplies rho by sqrt(prim/dual), and
# prim = |x - z| near 1e-6 is resolved by float32 to about 1e-2 relative;
# boxqp_big's solves allow it once per round (the rebalances compound) and
# only where the plain solve's prim is resolved at all: below
# UNRESOLVED * max(1, |x|, |z|) prim is float32 rounding, and rho follows it
RHO_RTOL = 2e-2
UNRESOLVED = 1e-5
# max abs difference of the outputs; (12, 2) covers norms up to 2, (12, 1)
# the non-normal d = 4 Liouvillians up to 1.6 (outputs up to e^1.6), (12, 4)
# the damped four-qubit chain's 256 x 256 Liouvillians up to its bound 5.16
EXPM_TOL = {(12, 0): 1e-5, (18, 12): 5e-3, (12, 2): 1e-5, (12, 1): 1e-5, (12, 4): 1e-5}
# d = 4: the kernel against the float64 plain result too
EXPM_F64_TOL = 1e-5
# admm_big against its plain version: iters float32 steps whose row sums run
# in another order, relative to max(1, |ref|), as QP_TOL for whole solves
ADMM_TOL = 1e-3
BORDERLINE = 1e-3          # acceptance flags may differ only this close to a threshold
TIMING_REPS = 20
FLEET_REPS = 4             # one warm-up run, then 3 timed runs (a fleet's "reps" overrides)
# boxqp_small's checked shapes and forms, by (n, B): the flagship's n = 10
# (cold warm phase, warm-started steady phase, that form Jacobi-scaled),
# not_gate's n = 15 (57.6 KB of shared memory a block), and the single
# rollout's n = 10 at B = 1, every solve cold at the library's 2x150 (the
# learned-model fleets solve the flagship's shape at that budget), and the
# embedded phase's batched_mpc at that budget on B = 1024; the warm forms
# start from the cold solve's dual and rho
QP_FORMS = {
    (10, BATCH): {"cold_3x12": dict(iters=12, rounds=3),
                  "warm_2x10": dict(iters=10, rounds=2, acc_abs=4e-3, acc_rel=4e-3),
                  "warm_2x10_scaled": dict(iters=10, rounds=2, acc_abs=4e-3, acc_rel=4e-3,
                                           scale=True),
                  "cold_2x150": dict(iters=150, rounds=2)},
    (15, 1024): {"cold_3x12": dict(iters=12, rounds=3),
                 "warm_2x10": dict(iters=10, rounds=2, acc_abs=4e-3, acc_rel=4e-3)},
    (10, 1): {"cold_2x150": dict(iters=150, rounds=2)},
    (10, 1024): {"cold_2x150": dict(iters=150, rounds=2)},
}
# Fleets: lanes, kernel launches per run, the fidelity gates (mean and
# minimum; None = no gate), the fraction of lanes that must exit early, and
# the lanes held against the float64 CPU path with their per-lane fidelity
# bound. freq's closed loop branches under float32 rounding (the JAX
# package's own float32 run ends up to 3.4e-4 from its x64 run, the port's
# 7.5e-4 over 128 CPU lanes), so its final-fidelity bound is 2e-3 and a
# 30-step run, before the branching, is held to 1e-5. lindblad branches
# from step 9, when its controls leave the box edge (JAX's own float32 run
# 9.0e-3 from x64 on 4 lanes; the port's float32 CPU run 2.0e-2 from
# float64 on these 64 lanes, median 8.5e-4): final bound 5e-2, and 8 steps
# held to 1e-5. not_gate's lanes are identical (its drift is 0): 8 lanes.
# So are crosstalk's at the fleet's coupling 0 (no drift to detune): 16
# lanes, and 32 more at coupling 0.05, where they differ (float32 against
# float64 on 8 CPU lanes: 1.2e-5 in the port, 5.0e-5 in the JAX package;
# bound 2e-4). cnot (order 2, lanes under 0.99 re-run at order 3) branches
# under float32 between steps 70 and 100 (CPU, 8 lanes: 4e-6 at 70 steps,
# 2.8e-3 at 100 while the state still moves, 2.0e-4 at the end; the JAX
# package's own float32 run ends 2.5e-4 from its x64 run): final bound 2e-3
# on 8 lanes, and 60 steps held to 1e-4. Its launch counts are the main
# pass's.
# The decay floor of lindblad is its minimum gate (bench.py:463); its mean
# cannot reach 0.999 by physics.
FLEETS = {
    "not_state": dict(batch=BATCH, fid_mean=0.999, fid_min=0.998, parity_lanes=64,
                      parity_tol=1e-4,
                      launches={"boxqp_small": 26, "expm_small": 20, "admm_big": 0,
                                "condense_small": 26, "ns_cold": 0}),
    "not_gate": dict(batch=1024, kwargs=dict(n_steps=90), fid_mean=0.999, fid_min=None,
                     exit_early=1.0, parity_lanes=8, parity_tol=1e-4,
                     launches={"boxqp_small": 96, "expm_small": 90, "admm_big": 0,
                               "condense_small": 96, "ns_cold": 0}),
    "lindblad_state": dict(batch=BATCH, fid_mean=None, fid_min=0.85, parity_lanes=64,
                           parity_tol=5e-2, tracking=(8, 1e-5),
                           launches={"boxqp_small": 26, "expm_small": 20, "admm_big": 0,
                                     "condense_small": 26, "ns_cold": 0}),
    "drag_state": dict(batch=2048, fid_mean=0.999, fid_min=0.98, parity_lanes=64,
                       parity_tol=1e-4,
                       launches={"boxqp_small": 0, "expm_small": 20, "admm_big": 34,
                                 "condense_small": 0, "ns_cold": 0}),
    "not_state_freq": dict(batch=1024, fid_mean=0.999, fid_min=0.98, parity_lanes=32,
                           parity_tol=2e-3, tracking=(30, 1e-5),
                           launches={"boxqp_small": 0, "expm_small": 100, "admm_big": 114,
                                     "condense_small": 0, "ns_cold": 114}),
    # 203 = 7 + 49 x 4 cold solves of one round
    "crosstalk": dict(batch=1024, reps=2, fid_mean=None, fid_min=0.98, parity_lanes=16,
                      parity_tol=1e-4,
                      variant=dict(kwargs=dict(coupling=0.05), lanes=32, tol=2e-4),
                      launches={"boxqp_small": 0, "expm_small": 50, "admm_big": 203,
                                "condense_small": 0, "ns_cold": 203}),
    # 222 = 8 x 3 warm rounds + 198 x 1 steady round
    "cnot_state": dict(batch=128, reps=2, kwargs=dict(order=2), fid_mean=None, fid_min=0.99,
                       rescue=dict(threshold=0.99, kwargs=dict(order=3)), parity_lanes=8,
                       parity_tol=2e-3, tracking=(60, 1e-4),
                       launches={"boxqp_small": 0, "expm_small": 200, "admm_big": 222,
                                 "condense_small": 0, "ns_cold": 222}),
}
# the rescue pass on the card: cnot at order 2 cut to 20 steps, every lane
# marginal (threshold above 1), re-run at order 3 on a batch padded from 6
# lanes to 8; launches of the main pass 20 / 8 x 3 + 18 and of the rescue
# the same; kept states against the float64 CPU path
RESCUE = dict(lanes=6, steps=20, tol=1e-4,
              launches={"boxqp_small": 0, "expm_small": 20, "admm_big": 42,
                        "condense_small": 0, "ns_cold": 42})
# The two scenarios of no preset that the JAX package runs as any Scenario
# (8 warm SQP iterations, cold duals, their own 3x300 in both phases),
# built from the port's constructors (presets.damped_pair_scenario,
# presets.cnot_h80_scenario): damped_pair, cnot_state's pair with amplitude damping
# (every plant step one expm_small launch at d 16, its tile instance, QP n
# 150), and cnot_h80, cnot_state at horizon 80 (QP n 240, admm_big's
# cluster instance). At
# cnot's batch with all 200 steps; gates: every lane completes, no QP
# fails; launches a run as the runner's budgets give them
# (expected_launches); 4 lanes over 12 steps within 1e-3 of the port's
# float64 CPU run on the same plants in the final fidelity, exit codes
# equal (the float32 closed loop of cnot_state tracks float64 to 1e-4
# over 60 steps and branches between steps 70 and 100). Two more at full
# width launch the last two kernel instances: damped_chain4
# (presets.damped_chain4_scenario: four damped qubits, every plant step one
# expm_small launch at d 256 in its cluster2d instance at the budget (12, 4)
# expm_budget_for gives the chain; QP n 32, 6 steps, the default 2x150) at
# B 128, whose float32 closed loop branches from float64 in step 1's eight
# line-searched SQP iterations, as the three-qubit problem's does (tp_3q),
# only further: the JAX package's own float32 run ends more than 5e-2 from
# its x64 run and the port's float32 CPU run more than 1e-3 from float64
# (tests/test_torch_large.py::test_chain_float32_branches_in_jax_too), so
# its first step is held to 1e-5 of float64 (tracking) and the final
# fidelity of all 6 steps to 5e-2, exit codes equal; and cnot_h250
# (presets.cnot_h250_scenario: QP n 750, admm_big's cluster instance at 10 CTAs a
# lane, 0 / 200 / 642 launches a run) at B 16, 2 lanes over 6 steps held
# to float64 (cut from cnot_h80's 4 x 12: its 642 cold Newton-Schulz K^-1
# builds at n 750 make the float64 CPU run about 30 s a lane-step on one
# thread). Its float32 QPs complete only with the Newton-Schulz K^-1's last
# step formed in float64 (solvers/boxqp.ns_inverse): float32's own
# iteration stalls near 1e-5 at n 750 and, on the card at B 16, step 0's
# QPs failed acceptance by up to 3.7x (perf_qp_floor.py).
SLICE_FLEETS = {"damped_pair": dict(batch=128, reps=2, parity_lanes=4, parity_steps=12,
                                    parity_tol=1e-3),
                "cnot_h80": dict(batch=128, reps=2, parity_lanes=4, parity_steps=12,
                                 parity_tol=1e-3),
                "damped_chain4": dict(batch=128, reps=2, parity_lanes=4, parity_steps=6,
                                      parity_tol=5e-2, tracking=(1, 1e-5)),
                "cnot_h250": dict(batch=16, reps=2, parity_lanes=2, parity_steps=6,
                                  parity_tol=1e-3)}
# The learned-model cells, on the flagship's problem (not_state, n = 10):
# every lane carries its own model, refit after each step (streaming), and
# every QP runs cold at the library's 2x150 (benchfleet.make_runner's
# streaming rule). learn_fleet: an OnlineDMDc (RLS, alpha 1e2, discount 1)
# bootstrapped from the analytic order-2 operator, full-state measurement
# with noise at sigma 1e-5 drawn on the card, recorded. At the JAX package's
# noisy-test scale 1e-4 the JAX host loop itself loses lanes below 0.95
# (4 of 64 in float64, mean 0.98712; the port loses the same lanes:
# tests/test_torch_learn.py::test_reference_loses_the_same_lanes), so the
# gated cell runs at 1e-5, where every lane reaches 0.995. discrep_fleet: a
# DiscrepDMDc of capacity 12, noiseless, its pinv cut at rcond = 10
# max(m, n) eps of float32 (the JAX pinv's own default cut; at the JAX
# tests' rcond 1e-15 float32 inverts rounding and 98 of 256 CPU lanes fail,
# and even in float64 the JAX loop's mean is 0.98950 on 256 lanes, one lane
# at 0.898), so its mean gate is 0.985. Launches a run as the flagship's,
# but for condense_small, which takes a shared model only (each lane has its
# own here): the refit is plain PyTorch (RLS; the discrepancy fit's batched
# SVDs are library calls).
# learn_fleet's first probe_lanes lanes run once more, ungated, at sigma
# 1e-4 (probe_sigma) to report the lanes below the gate there;
# discrep_fleet's 64 parity lanes report their float64 mean beside the
# card's.
LEARN = dict(batch=BATCH, sigma=1e-5, alpha=1e2, fid_lane=0.95, fid_mean=0.99, parity_lanes=8,
             parity_tol=1e-3, probe_sigma=1e-4, probe_lanes=512,
             launches={"boxqp_small": 26, "expm_small": 20, "admm_big": 0, "condense_small": 0,
                       "ns_cold": 0})
DISCREP = dict(batch=1024, capacity=12, rcond=10 * 12 * float(np.finfo(np.float32).eps),
               fid_lane=0.95, fid_mean=0.985, parity_lanes=64, parity_tol=1e-3,
               launches={"boxqp_small": 26, "expm_small": 20, "admm_big": 0, "condense_small": 0,
                         "ns_cold": 0})
# the single-rollout phases (mpc(), B = 1): P(|1>) gate and the bound on its
# distance from the same call in float64 on the CPU; on the default chol
# backend a rollout launches no QP kernel, and condense_small once an SQP
# iteration (chol_launches, with that count)
SINGLE = dict(p1=0.95, cpu_tol=1e-3, loss=1e-3,
              chol_launches={"boxqp_small": 0, "expm_small": 20, "admm_big": 0, "ns_cold": 0})
# The command line and the single-rollout solver surface, on the flagship.
# cli_rollout: `python -m mpc4quantum_tpu_torch not_state` (the chol QP;
# the JAX package's single rollout reaches 0.9988) against its --cpu run in
# float64 (the port's float32 CPU run is 5.4e-8 from it). cli_lqr: the LQR
# rollout's controls chatter on the box edge and each step that leaves the
# edge amplifies rounding about a thousandfold (float64 against the JAX
# package: 1.4e-12 over 16 steps, 1.5e-8 at step 20; float32 against
# float64 on the CPU: equal over 10 steps, then apart by up to 0.38). Its
# first 10 controls are held to 1e-4 of float64 and every control to sat
# (float32 rounds sat up by 1.7e-8: relative slack 1e-6). Those first
# controls sit on the box edge, so they do not hold the gain solve: the
# first step's LQR (gains and controls, unclipped, all inside the box) is
# held to 1e-4 of float64 relative to its largest entry (float32 on the
# CPU: 1.4e-7 on both). The JAX
# package's bar, P(|1>) > 0.95, is that of its float64 test, and holds the
# float64 run (0.97883); in float32 the rollout's end is a draw: the JAX
# package's own float32 run ends at 0.90465 (0.92473 with the Taylor plant
# step), the port's float32 CPU run over 48 perturbations of x0 at 1e-7
# between 0.89706 and 0.99880 (median 0.93598), the card's first run at
# 0.92014; so the card's run is held to 0.85
# (tests/test_torch_solvers.py::test_lqr_float32_end_is_a_draw_in_jax_too). cli_batch: `--batch 1024` (batched_mpc, chol), its first 8 lanes
# again on the card and in float64 on the CPU. fleet_checkpoint: the
# flagship fleet through `--hostloop --checkpoint`, then a fleet-runner run
# that crashes after step 9 and is resumed. chol_qp: solve_boxqp alone on
# the flagship's shape, cold, at the library's 2x150, against its float64
# solve of the same QPs, and boxqp_small 3x12 on them for the reader.
CLI = dict(fid=0.995, cpu_tol=1e-4, lqr_close_steps=10, lqr_close_tol=1e-4, sat_rtol=1e-6,
           lqr_p1_f32=0.85, lqr_step0_rtol=1e-4,
           batch=1024, batch_fid_min=0.998, parity_lanes=8, ckpt_every=5, crash_step=10,
           chol_accept=0.99,
           launches={"boxqp_small": 0, "expm_small": 20, "admm_big": 0, "ns_cold": 0})
# The K-inverse family and the real-state path. kinv_builds: the four
# K^-1 forms (Newton-Schulz at the warm phase's ns_iters, Gauss-Jordan, the
# Riccati factorization and its log-depth scan) on a real linearization of
# each large-n fleet - its last warm-phase solve, K = P + (sigma + rho) I
# at the cold rho - timed by CUDA events; each residual ||I - K X||_inf
# (largest row sum, worst lane) and the gap to numpy's float64 inverse of
# the same K on 4 lanes, relative to its largest entry: within 1e-3 for the
# exact forms (the card: 4.4e-5 and 1.8e-6 at conditions 65-274), within
# 1e-2 for Newton-Schulz, whose residual is its truncation at the budget
# (freq's 20 steps: 2.1e-4 and 1.1e-4). riccati_fleet: cnot
# under kinv="riccati" and freq under "riccati_pscan" with the default
# phases' gates, launches and float64 lane bounds; the float64 reference is
# the default phase's own (in float64 the four inverses agree to 1e-14, so
# the closed loop does not see which one ran: tests/test_torch_riccati.py).
# warm_kinv_fleet: the steady K-inverse carry on freq, and on drag with
# kinv="ns" (its tuned Gauss-Jordan inverse leaves nothing to carry). On
# these fleets the carried inverse drifts out of the guard's contraction
# region at a drift spike (freq: step 21, guard residual 3-8; drag: every
# step rebuilds P), the guard sends every lane to the cold init at the
# refresh budget, and every lane then fails its QP: the JAX package's own
# run of this carry on its chip loses every lane (freq fidelity
# 0.69850 / 0.69489, drag 0.23165 / 0.23121, experiments/logs/
# r4_warm_kinv.log), and so does the port in float64 on the CPU (0.69779,
# 0.23145). So the phase holds the carry to the float64 CPU path of the
# same carried fleet (8 lanes: exit codes equal, fidelity within the
# default phase's bound), requires the carry to engage and the fallbacks to
# be counted, and reports the fleet without the carry beside it.
KINV = dict(fleets={"not_state_freq": 1024, "drag_state": 2048, "cnot_state": 128},
            forms=("ns", "gj", "riccati", "riccati_pscan"), ref_lanes=4,
            tol={"ns": 1e-2, "gj": 1e-3, "riccati": 1e-3, "riccati_pscan": 1e-3})
RICCATI_FLEETS = {"cnot_state": "riccati", "not_state_freq": "riccati_pscan"}
WARM_KINV_FLEETS = {"not_state_freq": None, "drag_state": "ns"}
# classical: the Van der Pol Koopman MPC of tests/test_classical_mpc.py (mu
# 1, dt 0.1, 400 random-drive training steps from numpy seed 0, the lift
# [x1, x2, x1^2, x1^2 x2], H 20, 60 steps, sat 4, from (1.5, 0)), mpc() on
# the chol default and on the kernel route (n = 20: boxqp_big, one admm_big
# launch a rho round), |x_final| < 0.2 on both (JAX's bar); then
# batched_mpc on the kernel route at B 1024 from the 1.5-radius circle, 8
# lanes held to 1e-3 of float64 on the CPU in the final state (the card:
# 1.8e-7). embedded: the flagship's mpc() (B 1) and batched_mpc (B 1024)
# on the kernel route in the real embedding against the complex problem:
# |du| <= 1e-4 on the rollout (the card: 1.2e-5); on the batch 5e-4, since
# float32 alone moves its controls by about 1e-4: the phase also runs the
# complex batch in float64 on the CPU and reports the card's complex
# controls' distance from it beside the embedded one's (tests/
# test_torch_realstate.py holds the two loops equal in float64).
CLASSICAL = dict(mu=1.0, dt=0.1, train_steps=400, H=20, n_steps=60, sat=4.0, x0=(1.5, 0.0),
                 x_final=0.2, batch=1024, radius=1.5, parity_lanes=8, parity_tol=1e-3)
EMBEDDED = dict(batch=1024, du_tol={"mpc": 1e-4, "batched": 5e-4})
# The multi-device layer, on a one-rank NCCL group (the machine has one
# card). tp_3q: the JAX package's 3-qubit tensor-parallel problem (dim_s 8,
# dim_x 64, dim_u 3, H 8, 6 steps; tests/test_tensor_parallel.py) through
# batched_mpc at B 1024 on the kernel route (n = 24: boxqp_big, one admm_big
# launch a rho round; every plant step one expm_small launch at d 8, budget
# (12, 2)), dense and with tp_model_fns on a one-rank "op" axis. Its gates:
# every lane completes and ends above 0.97 (JAX's bar is 0.5; float64 on the
# CPU ends at 0.9813-0.9814 on these lanes), the TP run's exit codes equal
# the dense run's and its final fidelities are within 1e-4 of them (on one
# rank its arithmetic is the dense run's: expected equal), and 8 lanes'
# final fidelity is within 5e-3 of the float64 CPU run. float32 alone moves
# it that far (perf_parallel.py, the same 8 lanes): on the card 4.0e-4 run as
# 8 lanes and 1.2e-3 inside the B 1024 batch (other GEMM shapes, other
# rounding), 4.0e-4 with expm_small's plain version, 1.5e-4 with
# admm_big's, 3.1e-5 in float32 on the CPU; in float64 the card (plain
# versions) is 2.0e-12 from the CPU. Every lane still ends at 0.981-0.983;
# the controls branch, by 0.35-0.54, and are not held. sharded_fleet: the flagship at B 16384 through
# sharded_mpc(scenario_mesh()) on the kernel route (boxqp_small, n 10),
# lane for lane against batched_mpc on the same plants (the one rank runs
# the whole batch: equal to 1e-6, expected bit-equal), the summary's
# all_reduce against fleet_summary, scaling_report at one device, and the
# flagship's gates (every lane completes, no QP failure, min >= 0.998;
# float64 on the CPU: min 0.9986 over 256 lanes).
TP3Q = dict(batch=1024, fid_min=0.97, parity_lanes=8, parity_tol=5e-3, tp_gap=1e-4,
            expm_budget=(12, 2))
SHARDED = dict(batch=BATCH, fid_min=0.998, equal_tol=1e-6)
# admm_big alone: (B, n, iters) of the large-n presets' solves, cnot's
# n = 150 (rows split over 4 threads) and the largest n of the register
# instances (part of each row in shared memory); then crosstalk's and
# cnot's own, the classical phase's Koopman QP (n = 20: 12 of the n <= 32
# instance's columns idle) at B 1024 and at B 1 (three of a block's four
# lanes empty), tp_3q's (n = 24, the library's 150 iterations a round), the
# damped pair's launch (n 150 at B 128, 300 iterations a round: its QPs run
# cold at 3 x 300); the cluster instance: cnot_h80's n 240 at its batch, at
# 80 and 100 iterations and at the 300 a round its cold QPs launch, n 241
# (rows the cluster does not divide), one cluster alone (B 1), n 320 and
# 512 (clusters of 2 and 4), 736 (8 CTAs), 737 (10, above the portable 8),
# cnot_h250's launch (B 16, n 750, 300 iterations) and its largest n, 1008
# (16 CTAs); then the streaming instance (a cluster of 16 CTAs a lane) at n
# 1009, 1024 and 4096, and on the workspace at n 29,057 (one lane of a
# 3.4 GB K^-1, two iterations)
ADMM_SHAPES = ((2048, 32, 50), (2048, 32, 19), (1024, 50, 40), (256, 150, 50), (256, 239, 50),
               (1024, 40, 150), (128, 150, 100), (128, 150, 80), (1024, 20, 150), (1, 20, 150),
               (1024, 24, 150), (128, 150, 300), (128, 240, 80), (128, 240, 100),
               (128, 240, 300), (128, 241, 80), (1, 240, 300), (64, 320, 50), (16, 512, 50),
               (16, 736, 50), (16, 737, 50), (16, 750, 300), (16, 1008, 50), (16, 1009, 50),
               (1, 1024, 10), (2, 4096, 10), (1, 29057, 2))
# from this n on admm_input builds K^-1 directly, a seeded symmetric matrix
# of K^-1's scale (the kernel only multiplies by it): Gauss-Jordan of the
# 29,057 x 29,057 QP would take hours
ADMM_DIRECT_N = 2048
# the bound's peaks: one H100 SXM at its 700 W limit (NVIDIA's data sheet),
# float32 outside the tensor cores and device memory
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# expm_small's checked shapes: (B, d, taylor_k, max_squarings, least and
# largest 1-norm); d = 4 at (12, 1) on Liouvillians, the others on -i H
EXPM_CASES = {"d2_12_0": (BATCH, EXPM_D, 12, 0, 1e-3, 0.8),
              "d2_18_12": (BATCH, EXPM_D, 18, 12, 0.25, 2.0 ** 10),
              "d3_12_2": (2048, 3, 12, 2, 0.05, 2.0),
              "d4_12_1": (BATCH, 4, 12, 1, 0.05, 1.6),
              "d2_12_0_b1024": (1024, EXPM_D, 12, 0, 1e-3, 0.8),
              "d4_12_0_b1024": (1024, 4, 12, 0, 1e-3, 0.8),
              "d4_12_0_b128": (128, 4, 12, 0, 1e-3, 0.8),
              # the single rollout's plant step and quantum_simulate's one
              # call for the 48-step Blackman drive
              "d2_12_0_b1": (1, EXPM_D, 12, 0, 1e-3, 0.8),
              "d2_12_0_b48": (48, EXPM_D, 12, 0, 1e-3, 0.8),
              # d 5-8 (a team of 8 threads): tp_3q's plant step at d 8 and
              # its budget, the certified form at d 8, and d 5-7
              "d8_12_2_b1024": (1024, 8, 12, 2, 0.05, 2.0),
              "d8_12_0_b1024": (1024, 8, 12, 0, 1e-3, 0.8),
              "d5_12_2_b1024": (1024, 5, 12, 2, 0.05, 2.0),
              "d6_12_2_b1024": (1024, 6, 12, 2, 0.05, 2.0),
              "d7_12_2_b1024": (1024, 7, 12, 2, 0.05, 2.0),
              # the tile instance: two qutrits (d 9), damped_pair's plant
              # step (16 x 16 Liouvillians at its budget (12, 1)), four
              # qubits in the certified form, d 17 (a partial tile) and
              # d 32; the cluster instance at d 64, 97, 98, 100 and its
              # largest d, 116; the cluster2d instance at d 117 and 128
              # (4 x 4 tiles of 32), 129 (3 x 3 of 48), 256 (4 x 4 of 64)
              # and damped_chain4's plant step (B 128, d 256, its 256 x 256
              # Liouvillians up to the chain's norm bound 5.16 at its
              # budget (12, 4)); the grid2d instance at d 300
              "d9_12_2_b1024": (1024, 9, 12, 2, 0.05, 2.0),
              "d16_12_1_b128": (128, 16, 12, 1, 0.05, 1.6),
              "d16_12_0_b1024": (1024, 16, 12, 0, 1e-3, 0.8),
              "d17_12_2_b128": (128, 17, 12, 2, 0.05, 2.0),
              "d32_12_2_b128": (128, 32, 12, 2, 0.05, 2.0),
              "d64_12_2_b16": (16, 64, 12, 2, 0.05, 2.0),
              "d97_12_2_b4": (4, 97, 12, 2, 0.05, 2.0),
              "d98_12_2_b4": (4, 98, 12, 2, 0.05, 2.0),
              "d100_12_2_b4": (4, 100, 12, 2, 0.05, 2.0),
              "d116_12_2_b4": (4, 116, 12, 2, 0.05, 2.0),
              "d117_12_2_b4": (4, 117, 12, 2, 0.05, 2.0),
              "d128_12_2_b4": (4, 128, 12, 2, 0.05, 2.0),
              "d129_12_2_b4": (4, 129, 12, 2, 0.05, 2.0),
              "d256_12_2_b4": (4, 256, 12, 2, 0.05, 2.0),
              "d256_12_4_b128": (128, 256, 12, 4, 0.5, 5.16),
              "d300_12_2_b2": (2, 300, 12, 2, 0.05, 2.0)}
# the cases on Liouvillians (non-normal, both squaring branches), the
# Lindblad plants' steps; the others on -i H
EXPM_LIOUVILLIAN = ("d4_12_1", "d16_12_1_b128", "d256_12_4_b128")
# a real float32 batch at d 4 (expm_pallas takes real input): run as
# complex64, the real part returned
EXPM_REAL = (1024, 4, 12, 2)
# a NaN matrix at d 8 (a team), d 16 (the tile instance), d 100 (a
# cluster of 8: the cluster-wide norm), d 256 (a cluster of 16 tiles) and
# d 300 (the grid instance: its matrices' squaring counts differ), by batch
# and the NaN matrix's index
EXPM_NAN = {8: (301, 7), 16: (301, 7), 100: (4, 1), 256: (4, 1), 300: (3, 1)}
# ptxas must report no spill stores or loads in these instances: the seven
# expm teams, the 25 tile instances (d 1, 9-32), the cluster instance, the
# three cluster2d ones (tiles of 32, 48, 64) and the grid2d one, the five
# admm_big register instances, the cluster instance and the two streaming
# ones
EXPM_INSTANCES = (*(f"expm_small_kernelILi{d}E" for d in range(2, 9)), "expm_tile_kernel",
                  "expm_cluster_kernel", "expm_wide_kernel")
NO_SPILL = ("boxqp_small_kernelILi10E", "boxqp_small_kernelILi15E", "admm_big_kernel",
            "admm_cluster_kernel", "admm_stream_kernel", *EXPM_INSTANCES,
            "condense_small_kernelILi4ELi16E", "condense_small_kernelILi16ELi16E",
            "ns_cold_kernel")
INSTANCE_COUNT = 4 + (5 + 1 + 2) + (7 + 25 + 1 + 3 + 1) + 2 + 1
# condense_small at the flagship's shapes (B 1, the single rollout's; 16,384
# and 131,072, the fleets') and not_gate's (dim_x 16, n 15, B 1,024): each
# output against the plain version within CONDENSE_TOL of its largest entry
# (float32 sums in another order), timed
CONDENSE_SHAPES = (("not_state", 16384), ("not_state", 1), ("not_state", 131072),
                   ("not_gate", 1024))
CONDENSE_TOL = 1e-4
# ns_cold (B, n, iters) against the plain chain (solvers/boxqp._ns_inverse)
# on SPD K whose lanes' conditions run from 1e2 to 1e5: per lane ||I - K X||_inf
# within 2x the plain chain's + 1e-6, one graph node a call, and
# max |X - X_plain| within NSINV_REL of max |X_plain|: a chain that
# has not converged at its budget (condition 1e5 at 16-30 steps) carries the
# rounding of another order of sums, amplified (1.3e-3 in a float32 mirror of
# the kernel's arithmetic on the CPU; converged chains agree to ~1e-6). At
# NSINV_TIMED (cnot_state's B 1,024 n 150 and not_state_freq's n 50 at 20
# steps, cnot's chip_smoke batch 128) the device time beside the plain chain,
# torch.linalg.inv_ex (the library's inverse, a yardstick the port never
# calls; timed by events alone: it cannot be captured in a CUDA graph) and
# the bound of the chain's full products (nsinv_work)
NSINV_SHAPES = ((128, 17, 20), (128, 24, 20), (128, 32, 16), (128, 40, 20), (128, 50, 16),
                (128, 150, 30), (128, 152, 20), (1, 150, 20), (1024, 150, 20), (1024, 50, 20),
                (128, 150, 20))
NSINV_TIMED = ((1024, 150, 20), (1024, 50, 20), (128, 150, 20))
NSINV_REL = 5e-3
# and at its random shared models (kernels/condense.CONDENSE_MODELS) at B 333,
# a partial last block
CONDENSE_MODEL_BATCH = 333
# every plan the kernel library computes against the Python one
PLAN_BATCHES = (1, 4, 16, 128, 1024, BATCH)
PLAN_SIZES = {"expm_small": 160, "admm_big": 4096}
# The redesigned instances against the first ones and the library: the
# tile instance at damped_pair's d 16 B 128 (12, 1), the cluster instance
# at cnot_h80's launch (B 128, n 240, 300 iterations), the cluster2d
# instance at d 117 B 4 (12, 2), the cluster instance at 10 CTAs (B 16,
# n 737, 50 iterations) and the streaming one (B 1, n 1024, 10 iterations)
# must take less device time than the first block and streaming instances
# took on an H100 80GB HBM3 at 700 W (PERF.md section 6: 10.82, 2,044.90,
# 1,380.20, 2,492.42 and 558.33 us), and the instances at d 100, 117 and
# 128 B 4 less than torch.linalg.matrix_exp on the same batch. The first
# ones are times taken at a 700 W limit: they hold only on a card at that
# limit (a lower one runs slower under load). SPEED_RECORDED: beside
# matrix_exp, not gated (damped_chain4's plant step).
SPEED_BOUNDS_US = {("expm_small", "d16_12_1_b128"): 10.82,
                   ("admm_big", "B128_n240_it300"): 2044.90,
                   ("expm_small", "d117_12_2_b4"): 1380.20,
                   ("admm_big", "B16_n737_it50"): 2492.42,
                   ("admm_big", "B1_n1024_it10"): 558.33}
SPEED_BOUNDS_WATTS = 700.0
SPEED_LIBRARY = ("d100_12_2_b4", "d117_12_2_b4", "d128_12_2_b4")
SPEED_RECORDED = ("d256_12_4_b128",)
# `--time-kernels [ROOT]`: device times of these shapes with the package of
# the checkout at ROOT, to set two commits side by side in one call
TIME_EXPM = ("d9_12_2_b1024", "d16_12_1_b128", "d16_12_0_b1024", "d32_12_2_b128",
             "d64_12_2_b16", "d100_12_2_b4", "d117_12_2_b4", "d128_12_2_b4", "d256_12_2_b4",
             "d256_12_4_b128")
TIME_ADMM = ((128, 150, 300), (128, 240, 80), (128, 240, 100), (128, 240, 300), (64, 320, 50),
             (16, 512, 50), (16, 737, 50), (16, 750, 300), (16, 1008, 50), (1, 1024, 10),
             (2, 4096, 10))
# boxqp_big, whole solves: drag's cold warm-phase and warm-started steady
# forms (Gauss-Jordan), freq's (Newton-Schulz), crosstalk's one form (every
# solve cold) and cnot's at eps 1e-8; the warm form starts from the cold
# solve's dual and rho. The QPs' diagonals are spread over orders of
# magnitude (qp_batch, spread 1) except for the last two, whose budgets at
# rho0 = 1.0 resolve the unspread QPs and not the spread ones
BIG_FORMS = {
    "drag": dict(B=2048, n=32, kinv="gj", cold=dict(iters=50, rounds=2),
                 warm=dict(iters=19, rounds=1, scale=True, acc_abs=4e-3, acc_rel=4e-3)),
    "freq": dict(B=1024, n=50, kinv="ns", cold=dict(iters=40, rounds=2, ns_iters=20),
                 warm=dict(iters=40, rounds=1, scale=True, ns_iters=16, acc_abs=4e-3,
                           acc_rel=4e-3)),
    "crosstalk": dict(B=1024, n=40, kinv="ns", spread=0.0,
                      cold=dict(iters=150, rounds=1, rho_scale=1.0, ns_iters=20)),
    "cnot": dict(B=128, n=150, kinv="ns", spread=0.0,
                 cold=dict(iters=100, rounds=3, rho_scale=1.0, ns_iters=20, eps_abs=1e-8,
                           eps_rel=1e-8),
                 warm=dict(iters=80, rounds=1, rho_scale=1.0, ns_iters=20, eps_abs=1e-8,
                           eps_rel=1e-8, acc_abs=4e-3, acc_rel=4e-3)),
}


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (t_s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_us(fn, reps: int = TIMING_REPS) -> float:
    """Microseconds of one fn() on the card without the host's dispatch:
    `reps` calls captured in a CUDA graph after a warm-up, one replay timed
    by CUDA events, divided by `reps`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps


def launch_floor_us() -> float:
    """The least time a graph node takes on the card: graph_us of a
    one-element in-place add, 20 of them dependent on each other."""
    x = torch.zeros(1, device=DEVICE)
    return graph_us(lambda: x.add_(1.0))


def bound(work) -> dict:
    """The least time the card could take for work = (flops, bytes): the
    larger of the operations over the float32 peak and the bytes over the
    memory rate, and which of the two it is."""
    flops, nbytes = work
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_us": max(t_ops, t_bytes) * 1e6,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    """max |a - b| relative to max(1, max |b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def phase_toolchain(build) -> dict:
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    rec = {"phase": "toolchain", "gpu": smi_line(), "device": torch.cuda.get_device_name(0),
           "python": sys.version.split()[0], "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": nvcc,
           "triton": importlib.util.find_spec("triton") is not None}
    emit(rec)
    return rec


def ptxas_entries(log: str) -> dict:
    """ptxas -v's report by function: registers of each entry function, and
    the stack and spill stores and loads of each function ptxas lists."""
    entries, entry, props = {}, None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entries.setdefault(entry, {})
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads", line)) and props:
            entries.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            entries[entry]["registers"] = int(m.group(1))
    return entries


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t0
    require(build.ptxas_log, "no ptxas report beside the kernel library")
    # the instantiations the fleets run and every admm_big and expm_small one
    report = {name: rec for name, rec in ptxas_entries(build.ptxas_log).items()
              if any(w in name for w in NO_SPILL)}
    emit({"phase": "build", "seconds": seconds, "nvcc_seconds": build.build_seconds,
          "ptxas": report})
    require(len(report) == INSTANCE_COUNT,
            f"expected 4 boxqp_small, 8 admm_big, 37 expm_small, 2 condense_small and 1 "
            f"ns_cold instances: {report}")
    spilled = {name: rec for name, rec in report.items()
               if rec.get("spill_stores", -1) != 0 or rec.get("spill_loads", -1) != 0}
    require(not spilled, f"spills in {spilled}")
    return report


def qp_batch(B: int, n: int, seed: int, spread: float = 0.0):
    """Random SPD box QPs, built as tests/test_pallas_qp.py builds them;
    spread > 0 weights rows and columns by exp(N(0, spread^2)), a diagonal
    over orders of magnitude as the large-n presets' condensed QPs have."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    # above n 511 by BLAS: numpy's einsum loop takes tens of seconds there
    GG = G @ np.swapaxes(G, 1, 2) if n >= 512 else np.einsum("bij,bkj->bik", G, G)
    P = GG + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n)) * 2
    if spread:
        d = np.exp(rng.normal(scale=spread, size=(B, n)))
        P, q = P * d[:, :, None] * d[:, None, :], q * d
    lb = -np.abs(rng.normal(size=(B, n)))
    ub = np.abs(rng.normal(size=(B, n)))
    return [torch.tensor(a, dtype=torch.float32, device=DEVICE) for a in (P, q, lb, ub)]


def compare_solves(name, kernel_out, plain_out, kw, accept, accept_thresholds,
                   rho_rtol=RHO_RTOL, rho_resolved_only=False) -> dict:
    """z, y, rho and acceptance flags of a kernel solve against the plain
    one; flags may differ only where a residual sits within BORDERLINE of
    its threshold in the plain solve, and with rho_resolved_only rho only
    where the plain prim is float32 rounding."""
    (zk, yk, ak), (zp, yp, ap) = kernel_out[:3], plain_out[:3]
    acc = (kw.get("eps_abs", 1e-6), kw.get("eps_rel", 1e-6), kw.get("acc_abs", 1e-3),
           kw.get("acc_rel", 1e-3))
    fk, fp = accept(ak, *acc), accept(ap, *acc)
    tol_p, tol_d = accept_thresholds(*ap[2:7], *acc)
    near = ((ap.prim - tol_p).abs() <= BORDERLINE * tol_p) | ((ap.dual - tol_d).abs() <= BORDERLINE * tol_d)
    differ = fk != fp
    drho = (ak.rho - ap.rho).abs() / ap.rho.abs()
    resolved = ap.prim >= UNRESOLVED * torch.clamp(torch.maximum(ap.xmax, ap.zmax), min=1.0)
    err = {"max_dz": float((zk - zp).abs().max()), "max_dy": float((yk - yp).abs().max()),
           "max_drho_rel": float(drho.max()),
           "max_drho_rel_resolved": float(torch.where(resolved, drho, 0.0).max()),
           "accepted_kernel": int(fk.sum()), "accepted_plain": int(fp.sum()),
           "flags_differ": int(differ.sum()),
           "flags_differ_not_borderline": int((differ & ~near).sum())}
    require(all(np.isfinite([err["max_dz"], err["max_dy"], err["max_drho_rel"]])),
            f"{name}: non-finite difference {err}")
    require(err["max_dz"] <= QP_TOL * max(1.0, float(zp.abs().max()))
            and err["max_dy"] <= QP_TOL * max(1.0, float(yp.abs().max())),
            f"{name}: iterates differ from the plain version {err}")
    rho_key = "max_drho_rel_resolved" if rho_resolved_only else "max_drho_rel"
    require(err[rho_key] <= rho_rtol, f"{name}: rho differs {err}")
    require(err["flags_differ_not_borderline"] == 0, f"{name}: acceptance flags differ {err}")
    return err


def phase_boxqp(boxqp_mod, accept_thresholds, graph_node_types, shape, floor_us) -> dict:
    """boxqp_small at a fleet's or the single rollout's shape (QP_FORMS):
    its cold warm-phase form, its warm-started steady form, and at n = 10
    that form Jacobi-scaled. Each solve is one kernel on the card and
    nothing else (the node types of a CUDA graph captured from it)."""
    n, B = shape
    forms = QP_FORMS[shape]
    P, q, lb, ub = qp_batch(B, n, seed=(0 if n == 10 else n) + (B == 1))
    rec = {"phase": "boxqp_small", "B": B, "n": n, "gpu": smi_line(), "launch_floor_us": floor_us}
    cold_start = {}
    for name, kw in forms.items():
        warm_start = {} if name.startswith("cold") else cold_start
        call_k = lambda: boxqp_mod.boxqp_small(P, q, lb, ub, **warm_start, **kw)
        call_p = lambda: boxqp_mod.boxqp_small_ref(P, q, lb, ub, **warm_start, **kw)
        out_k, out_p = call_k(), call_p()
        torch.cuda.synchronize()
        err = compare_solves(f"boxqp_small n={n} {name}", out_k, out_p, kw,
                             boxqp_mod.boxqp_accept, accept_thresholds)
        nodes = graph_node_types(call_k)
        require(nodes == [0], f"boxqp_small n={n} {name}: one solve put {nodes} on the card "
                              "(graph node types), not one kernel")
        work = boxqp_mod.boxqp_small_work(B, n, kw["iters"], kw["rounds"], x0=False,
                                          y0=bool(warm_start), rho0=bool(warm_start))
        err.update(graph_nodes=nodes, kernel_ms=cuda_ms(call_k), device_us=graph_us(call_k),
                   **bound(work),
                   plain_ms=cuda_ms(call_p))
        rec[name] = err
        if name == "cold_3x12":
            # the warm forms start from the cold solve's dual and rho
            cold_start = {"y0": out_p[1], "rho0": out_p[2].rho}
    rec["tolerance"] = {"z_y": QP_TOL, "rho_rel": RHO_RTOL, "flag_borderline": BORDERLINE}
    emit(rec)
    return rec


def plan_ids(mod, plan) -> tuple:
    """A Python plan as the kernel library reports it: (instance id,
    cluster size, threads, shared bytes)."""
    return (mod.INSTANCES.index(plan.instance), *plan[1:])


def phase_plans(build, expm_mod, admm_mod) -> dict:
    """Every launch plan of expm_small (d 1-160) and admm_big (n 1-4096) at
    the batches of PLAN_BATCHES, as the kernel library computes it, equals
    the Python plan (kernels/*.py `*_plan`)."""
    rec = {"phase": "plans", "batches": list(PLAN_BATCHES)}
    for kind, top in PLAN_SIZES.items():
        mod = expm_mod if kind == "expm_small" else admm_mod
        plan_fn = getattr(mod, f"{kind}_plan")
        differ, instances = [], {}
        for B in PLAN_BATCHES:
            for size in range(1, top + 1):
                plan = plan_fn(B, size)
                lib = build.plan(kind, B, size)
                if lib[:4] != plan_ids(mod, plan):
                    differ.append((B, size, lib[:4], tuple(plan)))
                instances.setdefault(plan.instance, [size, size])[1] = size
        rec[kind] = {"sizes": top, "differ": differ[:10], "n_differ": len(differ),
                     "instance_sizes": instances}
        require(not differ, f"{kind}: the library's plans differ from Python's {differ[:10]}")
    emit(rec)
    return rec


# the instances whose grid is B x cluster blocks (grid2d's is what the card
# holds at once)
GRID_B = ("tile", "cluster", "cluster2d", "stream", "stream_ws")


def check_launch(name, kind, mod, build, graph_kernel_launches, call, B, size) -> dict:
    """One call's launch three ways: the Python plan, the kernel library's
    plan (with the clusters of that shape the card holds at once) and the
    kernel node of a CUDA graph captured from the call; all must agree, so
    the instance the plan names - a cluster of its size - is the one that
    ran."""
    plan = getattr(mod, f"{kind}_plan")(B, size)
    lib = build.plan(kind, B, size, query=True)
    require(lib[:4] == plan_ids(mod, plan),
            f"{name}: the library plans {lib[:4]}, Python {plan}")
    launches = graph_kernel_launches(call)
    require(len(launches) == 1, f"{name}: {len(launches)} kernel launches in one call")
    got = launches[0]
    want = {"block": (plan.threads, 1, 1), "smem": plan.smem, "cluster": (plan.cluster, 1, 1)}
    if plan.instance in GRID_B:
        want["grid"] = (B * plan.cluster, 1, 1)
    require(all(got[k] == v for k, v in want.items()),
            f"{name}: the call launched {got}, the plan {plan}")
    if plan.cluster > 1:
        require(lib[4] >= 1, f"{name}: the card holds no cluster of {plan}")
    return {"plan": plan._asdict(), "max_active_clusters": lib[4], "launch": got}


def expm_batch(B: int, d: int, seed: int, max_norm: float, min_norm: float):
    """-i H for random Hermitian H with 1-norms log-uniform in [min_norm, max_norm]
    (so exp is unitary, the plant's form)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, d, d)) + 1j * rng.normal(size=(B, d, d))
    A = -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))
    norms = np.exp(rng.uniform(np.log(min_norm), np.log(max_norm), size=B))
    A = A * (norms / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]
    # row-major, as the plants hand it to the kernel (numpy may keep the
    # swapped axes' order in the result)
    return torch.tensor(np.ascontiguousarray(A), dtype=torch.complex64, device=DEVICE)


def liouvillian_batch(B: int, seed: int, max_norm: float, min_norm: float, levels: int = 2):
    """Non-normal D^2 x D^2 matrices (D = levels) shaped like a D-level system's
    dt (A0 + u A1) (a qubit's 4 x 4, a qubit pair's 16 x 16): A0 = -i[H0, .]
    + D[L], A1 = -i[H1, .] on row-major vec(rho) for random Hermitian H0,
    H1 and complex L, 1-norms log-uniform in [min_norm, max_norm]."""
    rng = np.random.default_rng(seed)
    herm = lambda G: 0.5 * (G + np.conj(np.swapaxes(G, 1, 2)))
    n = levels
    crandn = lambda: rng.normal(size=(B, n, n)) + 1j * rng.normal(size=(B, n, n))
    kron = lambda X, Y: np.einsum("bij,bkl->bikjl", X, Y).reshape(B, n * n, n * n)
    eye = np.broadcast_to(np.eye(n), (B, n, n))
    comm = lambda H: -1j * (kron(H, eye) - kron(eye, np.swapaxes(H, 1, 2)))
    H0, H1, L = herm(crandn()), herm(crandn()), 0.3 * crandn()
    LdL = np.conj(np.swapaxes(L, 1, 2)) @ L
    D = kron(L, np.conj(L)) - 0.5 * (kron(LdL, eye) + kron(eye, np.swapaxes(LdL, 1, 2)))
    A = comm(H0) + D + rng.uniform(-1, 1, size=(B, 1, 1)) * comm(H1)
    norms = np.exp(rng.uniform(np.log(min_norm), np.log(max_norm), size=B))
    A = A * (norms / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]
    # row-major, as the plants hand it to the kernel (numpy may keep the
    # swapped axes' order in the result)
    return torch.tensor(np.ascontiguousarray(A), dtype=torch.complex64, device=DEVICE)


def expm_input(name: str) -> torch.Tensor:
    """The batch of EXPM_CASES[name]: Liouvillians for EXPM_LIOUVILLIAN
    (the Lindblad plants' steps), -i H for the others."""
    B, d, k, sq, lo, hi = EXPM_CASES[name]
    if name in EXPM_LIOUVILLIAN:
        return liouvillian_batch(B, seed=k + d, max_norm=hi, min_norm=lo,
                                 levels=int(round(d ** 0.5)))
    return expm_batch(B, d, seed=k + d, max_norm=hi, min_norm=lo)


def admm_input(B: int, n: int, iters: int, gj_inverse):
    """admm_big's arguments at (B, n, iters): SPD QPs (qp_batch), K^-1 by
    Gauss-Jordan, seeded rho and iterates; from n = ADMM_DIRECT_N on K^-1
    is a seeded symmetric matrix (direct_kinv) and the vectors are drawn on
    the card. :return: (args, kwargs)."""
    rng = np.random.default_rng(n)
    rho = torch.tensor(rng.uniform(0.05, 2.0, B) * n, dtype=torch.float32, device=DEVICE)
    if n >= ADMM_DIRECT_N:
        g = torch.Generator(device=DEVICE).manual_seed(n + iters)
        draw = lambda scale: torch.randn((B, n), generator=g, device=DEVICE) * scale
        kinv = direct_kinv(B, n, rho, g)
        q, lb, ub = draw(2.0), -draw(1.0).abs(), draw(1.0).abs()
        x, z, y = draw(0.3), draw(0.3), draw(0.5)
    else:
        P, q, lb, ub = qp_batch(B, n, seed=n + iters)
        kinv = gj_inverse(P + (1e-6 + rho)[:, None, None] * torch.eye(n, device=DEVICE))
        x, z, y = (torch.tensor(rng.normal(size=(B, n)) * s, dtype=torch.float32, device=DEVICE)
                   for s in (0.3, 0.3, 0.5))
    return (kinv, q, lb, ub, rho, x, z, y), dict(iters=iters, sigma=1e-6, alpha=1.6)


def direct_kinv(B: int, n: int, rho: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """A symmetric (B, n, n) matrix of the scale of K^-1 = (P + rho I)^-1
    for a P of norm about rho: (I + S / 2) / (1 + rho), S a Wigner matrix
    of spectral radius about 1, drawn on the card from g."""
    G = torch.randn((B, n, n), generator=g, device=DEVICE)
    S = G + G.mT
    del G
    S.mul_(0.25 / (2 * n) ** 0.5)
    S.diagonal(dim1=1, dim2=2).add_(1.0)
    return S.div_((1.0 + rho)[:, None, None])


def phase_expm(expm_mod, graph_node_types, floor_us: float, build,
               graph_kernel_launches) -> dict:
    """expm_small: the flagship's d = 2 forms at its batch, drag's d = 3 at
    (12, 2) on its batch with the plant's norm range, lindblad's d = 4 at
    (12, 1) on non-normal Liouvillians across the 0- and 1-squaring
    branches, not_gate's and not_state_freq's d = 2 at (12, 0) on their
    batch of 1024, crosstalk's and cnot's d = 4 at (12, 0) on Hermitian
    generators at their batches, tp_3q's d = 8 at (12, 2) and the certified
    (12, 0) at B 1024, d = 5, 6 and 7, a NaN matrix at d = 8, the tile
    instance at d 9, 16 (damped_pair's 16 x 16 Liouvillians at (12, 1)), 17
    and 32, the cluster instance at d 64, 97, 98, 100 and 116, the workspace
    at d 117, NaN matrices at d 16 and 100, and a real float32 batch at
    d 4. Each call is one kernel on the card and nothing else, launched as
    its plan says (check_launch)."""
    rec = {"phase": "expm_small", "gpu": smi_line(), "launch_floor_us": floor_us}
    for name, (B, d, k, sq, lo, hi) in EXPM_CASES.items():
        A = expm_input(name)
        liouvillian = name in EXPM_LIOUVILLIAN
        call_k = lambda: expm_mod.expm_small(A, taylor_k=k, max_squarings=sq)
        call_p = lambda: expm_mod.expm_small_ref(A, taylor_k=k, max_squarings=sq)
        call_l = lambda: torch.linalg.matrix_exp(A)
        Ek, Ep = call_k(), call_p()
        E64 = expm_mod.expm_small_ref(A.to(torch.complex128), taylor_k=k, max_squarings=sq)
        torch.cuda.synchronize()
        # the squarings this input takes, for the work count
        norm1 = A.abs().sum(dim=-2).amax(dim=-1)
        squarings = int(torch.clamp(torch.ceil(torch.log2(torch.clamp(norm1, min=1.0))),
                                    0, sq).sum()) if sq else 0
        nodes = graph_node_types(call_k)
        require(nodes == [0], f"expm_small {name}: one call put {nodes} on the card "
                              "(graph node types), not one kernel")
        launch = check_launch(f"expm_small {name}", "expm_small", expm_mod, build,
                              graph_kernel_launches, call_k, B, d)
        err = {"B": B, "d": d, "norm_range": [lo, hi], "graph_nodes": nodes, **launch,
               "max_abs_err": float((Ek - Ep).abs().max()),
               "max_abs_err_vs_f64": float((Ek.to(torch.complex128) - E64).abs().max()),
               "kernel_ms": cuda_ms(call_k), "device_us": graph_us(call_k),
               **bound(expm_mod.expm_small_work(B, d, k, squarings)),
               "plain_ms": cuda_ms(call_p), "library_ms": cuda_ms(call_l)}
        rec[name] = err
        require(np.isfinite(err["max_abs_err"]) and err["max_abs_err"] <= EXPM_TOL[(k, sq)],
                f"expm_small {name} differs from the plain version {err}")
        if liouvillian:
            err["squared_frac"] = float((A.abs().sum(dim=-2).amax(dim=-1) > 1.0).float().mean())
            require(0.0 < err["squared_frac"] < 1.0, f"expm_small {name}: one branch only {err}")
        if d >= 4:
            require(err["max_abs_err_vs_f64"] <= EXPM_F64_TOL,
                    f"expm_small {name} differs from the float64 plain result {err}")
    # a NaN matrix (EXPM_NAN) comes out all NaN, its neighbours as the plain
    # version
    for d, (B, at) in EXPM_NAN.items():
        A = expm_batch(B, d, seed=d, max_norm=2.0, min_norm=0.05)
        A[at, d - 1, 0] = complex(float("nan"), 0.0)
        Ek, Ep = expm_mod.expm_small(A, 12, 2), expm_mod.expm_small_ref(A, 12, 2)
        torch.cuda.synchronize()
        rest = torch.arange(B, device=DEVICE) != at
        nan = {"B": B, "plan": expm_mod.expm_small_plan(B, d)._asdict(),
               "nan_matrix_all_nan": bool(torch.isnan(torch.view_as_real(Ek[at])).all()),
               "others_finite": bool(torch.isfinite(torch.view_as_real(Ek[rest])).all()),
               "others_max_abs_err": float((Ek[rest] - Ep[rest]).abs().max())}
        rec[f"d{d}_nan"] = nan
        require(nan["nan_matrix_all_nan"] and nan["others_finite"]
                and nan["others_max_abs_err"] <= EXPM_TOL[(12, 2)],
                f"expm_small d {d} NaN matrix: {nan}")
    # a real float32 batch: real out, one kernel, as the complex batch
    B, d, k, sq = EXPM_REAL
    A = expm_batch(B, d, seed=3, max_norm=2.0, min_norm=0.05).real.contiguous()
    before = expm_mod.expm_small.launches
    Ek, Ep = expm_mod.expm_small(A, k, sq), expm_mod.expm_small_ref(A, k, sq)
    E64 = expm_mod.expm_small_ref(A.double(), k, sq)
    torch.cuda.synchronize()
    real = {"B": B, "d": d, "dtype": str(Ek.dtype),
            "launches": expm_mod.expm_small.launches - before,
            "max_abs_err": float((Ek - Ep).abs().max()),
            "max_abs_err_vs_f64": float((Ek.double() - E64).abs().max())}
    rec[f"d{d}_real"] = real
    require(Ek.dtype == torch.float32 and real["launches"] == 1
            and real["max_abs_err"] <= EXPM_TOL[(k, sq)]
            and real["max_abs_err_vs_f64"] <= EXPM_F64_TOL, f"expm_small real input: {real}")
    rec["tolerance"] = {f"{k}_{sq}": t for (k, sq), t in EXPM_TOL.items()}
    rec["tolerance_d4_up_vs_f64"] = EXPM_F64_TOL
    emit(rec)
    return rec


def phase_admm(admm_mod, gj_inverse, build, graph_kernel_launches) -> dict:
    """admm_big against admm_iters_ref on SPD batches, K^-1 by Gauss-Jordan,
    seeded rho and iterates; each call launched as its plan says
    (check_launch)."""
    rec = {"phase": "admm_big", "tolerance": ADMM_TOL, "gpu": smi_line()}
    for B, n, iters in ADMM_SHAPES:
        args, kw = admm_input(B, n, iters, gj_inverse)
        x = args[5]
        call_k = lambda: admm_mod.admm_big(*args, **kw)
        call_p = lambda: admm_mod.admm_iters_ref(*args, **kw)
        out_k, out_p = call_k(), call_p()
        torch.cuda.synchronize()
        err = {f"rel_d{v}": rel_err(a, b) for v, a, b in zip("xzy", out_k, out_p)}
        err.update(check_launch(f"admm_big B={B} n={n} iters={iters}", "admm_big", admm_mod,
                                build, graph_kernel_launches, call_k, B, n))
        err.update(max_abs_err=max(float((a - b).abs().max()) for a, b in zip(out_k, out_p)),
                   kernel_ms=cuda_ms(call_k), device_us=graph_us(call_k),
                   **bound(admm_mod.admm_big_work(B, n, iters)), plain_ms=cuda_ms(call_p))
        if err["plan"]["instance"].startswith("stream"):
            # the streaming instances read K^-1 every iteration: their own
            # bytes bound beside the function's
            err["own_bytes_bound_us"] = admm_mod.stream_bytes(B, n, iters) / PEAK_BYTES * 1e6
        rec[f"B{B}_n{n}_it{iters}"] = err
        worst = max(err["rel_dx"], err["rel_dz"], err["rel_dy"])
        require(np.isfinite(worst) and worst <= ADMM_TOL,
                f"admm_big B={B} n={n} iters={iters} differs from the plain version {err}")
        require(float((out_p[0] - x).abs().max()) > 1e-3, "admm_big check is vacuous")
    emit(rec)
    return rec


def phase_speed(ex: dict, ad: dict) -> dict:
    """The redesigned instances' device times against SPEED_BOUNDS_US (on a
    card at SPEED_BOUNDS_WATTS or more) and, at SPEED_LIBRARY, against
    torch.linalg.matrix_exp in this run, from the expm_small and admm_big
    phases."""
    gpu = smi_line()
    watts = float(gpu.rsplit(",", 1)[1].strip().split()[0])
    rec = {"phase": "speed", "gpu": gpu, "bounds_held": watts >= SPEED_BOUNDS_WATTS}
    for (kind, name), first_us in SPEED_BOUNDS_US.items():
        got = (ex if kind == "expm_small" else ad)[name]["device_us"]
        rec[name] = {"device_us": got, "first_instance_us": first_us}
        require(got < first_us or not rec["bounds_held"],
                f"{kind} {name}: {got} us, the first instance took {first_us}")
    for name in SPEED_LIBRARY:
        got, lib = ex[name]["device_us"] / 1e3, ex[name]["library_ms"]
        rec[name] = {"device_ms": got, "library_ms": lib}
        require(got < lib, f"expm_small {name}: {got} ms, torch.linalg.matrix_exp {lib} ms")
    for name in SPEED_RECORDED:
        got, lib = ex[name]["device_us"] / 1e3, ex[name]["library_ms"]
        rec[name] = {"device_ms": got, "library_ms": lib, "kernel_over_library": got / lib,
                     "gated": False}
    emit(rec)
    return rec


def time_kernels(root: Path) -> int:
    """`--time-kernels [ROOT]`: the device time (graph_us) of expm_small at
    TIME_EXPM and admm_big at TIME_ADMM, with the package of the checkout at
    ROOT (default this one) built from its own sources, each call against
    its plain version; one JSON line. Run once a checkout, in turns, to put
    two commits side by side on one card."""
    sys.path.insert(0, str(root))
    from mpc4quantum_tpu_torch.kernels import _build as build
    from mpc4quantum_tpu_torch.kernels import admm_big as admm_mod
    from mpc4quantum_tpu_torch.kernels import expm as expm_mod
    from mpc4quantum_tpu_torch.utils.linalg import gj_inverse

    require(Path(build.__file__).resolve().is_relative_to(root.resolve()),
            f"the package came from {build.__file__}, not {root}")
    build.library()
    rec = {"measure": "kernels", "root": str(root), "gpu": smi_line(),
           "launch_floor_us": launch_floor_us()}
    for name in TIME_EXPM:
        B, d, k, sq, _, _ = EXPM_CASES[name]
        A = expm_input(name)
        call_k = lambda: expm_mod.expm_small(A, taylor_k=k, max_squarings=sq)
        err = float((call_k() - expm_mod.expm_small_ref(A, taylor_k=k, max_squarings=sq))
                    .abs().max())
        require(err <= EXPM_TOL[(k, sq)], f"expm_small {name}: {err}")
        rec[name] = {"device_us": graph_us(call_k), "max_abs_err": err,
                     "library_ms": cuda_ms(lambda: torch.linalg.matrix_exp(A))}
    for B, n, iters in TIME_ADMM:
        args, kw = admm_input(B, n, iters, gj_inverse)
        call_k = lambda: admm_mod.admm_big(*args, **kw)
        err = max(rel_err(a, b) for a, b in zip(call_k(), admm_mod.admm_iters_ref(*args, **kw)))
        require(err <= ADMM_TOL, f"admm_big B={B} n={n} iters={iters}: {err}")
        rec[f"B{B}_n{n}_it{iters}"] = {"device_us": graph_us(call_k), "rel_err": err,
                                       **bound(admm_mod.admm_big_work(B, n, iters))}
    # the SM clock after the timings, beside its maximum
    rec["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit(rec)
    return 0


def phase_condense(condense_mod, graph_node_types, floor_us) -> dict:
    """condense_small at CONDENSE_SHAPES and CONDENSE_MODELS: one kernel on
    the card a call (the nodes of a CUDA graph captured from it), each
    output against the plain version (model_along_traj + qp_data); at
    CONDENSE_SHAPES the device time against the bound of
    condense_small_work, and the plain version's times."""
    rec = {"phase": "condense_small", "gpu": smi_line(), "launch_floor_us": floor_us,
           "tolerance": CONDENSE_TOL}
    cases = [(name, B, True) for name, B in CONDENSE_SHAPES] + [
        (shape, CONDENSE_MODEL_BATCH, False) for shape in condense_mod.CONDENSE_MODELS]
    for case, B, timed in cases:
        p = condense_mod.condense_input(case, B)
        model = p["model"]
        label = case if timed else "x{}_h{}_u{}".format(*case)
        call_k = lambda: condense_mod.condense_small(**p)
        call_p = lambda: condense_mod.condense_small_ref(**p)
        out_k, out_p = call_k(), call_p()
        torch.cuda.synchronize()
        err = max(rel_err(a, b) for a, b in zip(out_k, out_p))
        require(err <= CONDENSE_TOL, f"condense_small {label} B={B}: {err}")
        del out_k, out_p
        nodes = graph_node_types(call_k)
        require(nodes == [0], f"condense_small {label} B={B}: one call put {nodes} on the "
                              "card (graph node types), not one kernel")
        row = {"max_rel_err": err, "graph_nodes": nodes}
        if timed:
            work = condense_mod.condense_small_work(B, model.dim_x, p["X"].shape[2],
                                                    model.dim_u, model.polyu_dim)
            row.update(kernel_ms=cuda_ms(call_k), device_us=graph_us(call_k), **bound(work),
                       plain_ms=cuda_ms(call_p), plain_device_us=graph_us(call_p))
            row["bound_pct"] = 100.0 * row["bound_us"] / row["device_us"]
        rec[f"{label}_b{B}"] = row
        torch.cuda.empty_cache()
    emit(rec)
    return rec


def spd_batch(B: int, n: int, seed: int) -> torch.Tensor:
    """B symmetric positive definite float32 (n, n) on the card, lane b of
    condition 10^(2 + 3 b / (B - 1)): Q diag(eigenvalues) Q^T from a random
    orthogonal Q, in float64, then rounded."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    Q = torch.linalg.qr(torch.randn(B, n, n, generator=g, dtype=torch.float64))[0]
    cond = torch.logspace(2, 5, B, dtype=torch.float64) if B > 1 else torch.tensor([1e3])
    ev = cond[:, None] ** torch.linspace(0, 1, n, dtype=torch.float64)[None]
    K = (Q * ev[:, None, :]) @ Q.mT
    return (0.5 * (K + K.mT)).to(DEVICE, torch.float32)


def nsinv_work(B: int, n: int, iters: int):
    """The chain's work counted as full products: iters steps of two n x n
    x n products a lane (FMA = 2 flops), K read and X written once."""
    return B * iters * 4 * n ** 3, 8 * B * n * n


def phase_nsinv(nsinv_mod, graph_node_types, floor_us) -> dict:
    """ns_cold at NSINV_SHAPES against the plain chain, timed at NSINV_TIMED."""
    from mpc4quantum_tpu_torch.solvers.boxqp import _ns_inverse

    rec = {"phase": "ns_cold", "gpu": smi_line(), "launch_floor_us": floor_us,
           "tolerance": NSINV_REL}
    for B, n, iters in NSINV_SHAPES:
        K = spd_batch(B, n, n)
        call_k = lambda: nsinv_mod.ns_cold(K, iters)
        call_p = lambda: _ns_inverse(K, iters)[0]
        Xk, Xp = call_k(), call_p()
        torch.cuda.synchronize()
        eye = torch.eye(n, dtype=torch.float64, device=DEVICE)
        resid = lambda X: (eye - K.double() @ X.double()).abs().sum(dim=-1).amax(dim=-1)
        rk, rp = resid(Xk), resid(Xp)
        rel = float(((Xk - Xp).abs().amax(dim=(-1, -2))
                     / Xp.abs().amax(dim=(-1, -2))).max())
        row = {"residual_max": float(rk.max()), "plain_residual_max": float(rp.max()),
               "residual_ratio_max": float((rk / (2 * rp + 1e-6)).max()), "max_rel_err": rel,
               "graph_nodes": graph_node_types(call_k)}
        label = f"B{B}_n{n}_it{iters}"
        require(row["residual_ratio_max"] <= 1.0 and rel <= NSINV_REL
                and row["graph_nodes"] == [0], f"ns_cold {label}: {row}")
        if (B, n, iters) in NSINV_TIMED:
            call_l = lambda: torch.linalg.inv_ex(K)[0]
            row.update(kernel_ms=cuda_ms(call_k), device_us=graph_us(call_k),
                       plain_ms=cuda_ms(call_p), plain_device_us=graph_us(call_p),
                       library_ms=cuda_ms(call_l),
                       **bound(nsinv_work(B, n, iters)))
            row["bound_pct"] = 100.0 * row["bound_us"] / row["device_us"]
        rec[label] = row
        del K, Xk, Xp
        torch.cuda.empty_cache()
    emit(rec)
    return rec


def phase_boxqp_big(boxqp_mod, BoxQPParams, solve_boxqp_fixed, accept_thresholds) -> dict:
    """boxqp_big (one admm_big launch per round) against the plain solver,
    whole solves at the large-n presets' shapes and budgets."""
    rec = {"phase": "boxqp_big", "tolerance": {"z_y": QP_TOL, "rho_rel_per_round": RHO_RTOL,
                                               "prim_unresolved": UNRESOLVED,
                                               "flag_borderline": BORDERLINE}}
    for preset, form in BIG_FORMS.items():
        P, q, lb, ub = qp_batch(form["B"], form["n"], seed=form["n"],
                                spread=form.get("spread", 1.0))
        warm_start = {}
        for phase in ("cold", "warm"):
            if phase not in form:
                continue
            kw = dict(form[phase])
            params = BoxQPParams(max_iter=kw["iters"], n_rounds=kw["rounds"],
                                 rho0=kw.get("rho_scale", 0.1), eps_abs=kw.get("eps_abs", 1e-6),
                                 eps_rel=kw.get("eps_rel", 1e-6),
                                 accept_abs=kw.get("acc_abs", 1e-3),
                                 accept_rel=kw.get("acc_rel", 1e-3), kinv=form["kinv"],
                                 ns_iters=kw.get("ns_iters", 30), scale=kw.get("scale", False))
            call_k = lambda: boxqp_mod.boxqp_big(P, q, lb, ub, **warm_start,
                                                 kinv_method=form["kinv"], **kw)
            call_p = lambda: solve_boxqp_fixed(P, q, lb, ub, **warm_start, params=params)
            out_k, out_p = call_k(), call_p()
            torch.cuda.synchronize()
            name = f"{preset}_{phase}_{kw['rounds']}x{kw['iters']}"
            err = compare_solves(f"boxqp_big {name}", out_k, out_p, kw,
                                 boxqp_mod.boxqp_accept, accept_thresholds,
                                 rho_rtol=RHO_RTOL * kw["rounds"], rho_resolved_only=True)
            err.update(B=form["B"], n=form["n"], kinv=form["kinv"],
                       kernel_ms=cuda_ms(call_k, 5), plain_ms=cuda_ms(call_p, 5))
            rec[name] = err
            warm_start = {"y0": out_p[1], "rho0": out_p[2].rho}
    emit(rec)
    return rec


def make_lanes(plant, n: int):
    """n lanes of a float64 CPU plant, from the fleets' seed."""
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    return make_scenario_batch(plant, n, generator=torch.Generator().manual_seed(1))


def rescue_spec(presets, name, **kw):
    """The fleet's rescue argument (None where it has none): its threshold
    and its alternative scenario, built like the fleet's own."""
    spec = FLEETS[name].get("rescue")
    if spec is None:
        return None
    return {"threshold": spec["threshold"],
            "scenario": presets.PRESETS[name](**spec["kwargs"], **kw)}


def phase_fleet(name, presets, run_hostloop_fleet, counters):
    """One fleet: one warm-up run, then the timed runs (3, or 1 on the two
    slowest fleets), with the kernels' launch counts set to 0 just before
    and read just after the whole call.
    Where the fleet has a rescue pass, that pass's own launches (the
    entry point reports them) are taken off: the counts are the main pass's."""
    spec = FLEETS[name]
    B, reps = spec["batch"], spec.get("reps", FLEET_REPS)
    make = fleet_preset(presets, name)
    sc = make()  # no device argument: on the card, in float32
    require(sc.x0.device.type == DEVICE and sc.plant.real_dtype == torch.float32,
            f"{name}: a preset built without a device is on {sc.x0.device}, {sc.plant.real_dtype}")
    plants64 = make_lanes(make(device="cpu", dtype=torch.float64).plant, B)
    for fn in counters.values():
        fn.launches = 0
    metrics, out = run_hostloop_fleet(sc, B, plants=plants64.to(DEVICE, torch.float32),
                                      reps=reps, rescue=rescue_spec(presets, name))
    rescued = metrics.get("rescue_launches", {})
    launches = {k: fn.launches - rescued.get(k, 0) for k, fn in counters.items()}
    final_x = out["final_x"]
    emit({"phase": "fleet", **metrics, "launches": launches, "runs": reps})
    dim = sc.x0.shape[0]
    require(tuple(final_x.shape) == (B, dim) and bool(torch.isfinite(final_x).all()),
            f"{name} fleet final states are not finite ({B}, {dim})")
    expected = {k: v * reps for k, v in spec["launches"].items()}
    require(launches == expected,
            f"{name} kernel launches over {reps} runs: {launches}, expected {expected}")
    require(metrics["completed_frac"] == 1.0 and metrics["qp_fail_frac"] == 0.0,
            f"{name} fleet lanes failed: {metrics}")
    require(metrics["exit_early_frac"] == spec.get("exit_early", 0.0),
            f"{name} fleet exit_early_frac is not {spec.get('exit_early', 0.0)}: {metrics}")
    gates = (("fidelity_mean", spec["fid_mean"]), ("fidelity_min", spec["fid_min"]))
    require(all(gate is None or metrics[key] >= gate for key, gate in gates),
            f"{name} fleet fidelity below the gates {gates}: {metrics}")
    return sc, plants64, out, launches, metrics


def phase_parity(name, presets, run_hostloop_fleet, fleet_fidelity, sc, plants64, out) -> dict:
    """The first lanes again, through the float64 plain path on the CPU."""
    spec = FLEETS[name]
    lanes, bound = spec["parity_lanes"], spec["parity_tol"]
    make = fleet_preset(presets, name)
    cpu = dict(device="cpu", dtype=torch.float64)
    sc64 = make(**cpu)
    m64, out64 = run_hostloop_fleet(sc64, lanes, plants=plants64[:lanes],
                                    rescue=rescue_spec(presets, name, **cpu))
    dfid = np.abs(fleet_fidelity(sc, out["final_x"][:lanes]) - fleet_fidelity(sc64, out64["final_x"]))
    codes_equal = bool((out["exit_code"][:lanes].cpu() == out64["exit_code"]).all())
    rec = {"phase": "lane_parity", "preset": name, "lanes": lanes,
           "max_abs_dfid": float(dfid.max()), "median_abs_dfid": float(np.median(dfid)),
           "bound": bound, "exit_codes_equal": codes_equal,
           "cpu_fidelity_mean": m64["fidelity_mean"]}
    if "tracking" in spec:
        # the same lanes over the first steps, before float32 rounding can
        # branch the closed loop
        steps, tbound = spec["tracking"]
        cut = lambda s: dataclasses.replace(s, config=dataclasses.replace(s.config, n_steps=steps))
        _, out_s = run_hostloop_fleet(cut(sc), lanes, plants=plants64[:lanes].to(DEVICE, torch.float32))
        _, out_s64 = run_hostloop_fleet(cut(sc64), lanes, plants=plants64[:lanes])
        tfid = float(np.abs(fleet_fidelity(sc, out_s["final_x"])
                            - fleet_fidelity(sc64, out_s64["final_x"])).max())
        rec["tracking"] = {"steps": steps, "max_abs_dfid": tfid, "bound": tbound}
        require(tfid <= tbound, f"{name}: first {steps} steps differ from the float64 CPU path: {rec}")
    if "variant" in spec:
        # the preset built with other arguments, on lanes of its own
        var = spec["variant"]
        n, scs = var["lanes"], [make(**var["kwargs"]), make(**var["kwargs"], **cpu)]
        lanes64 = make_lanes(scs[1].plant, n)
        fids = [fleet_fidelity(s, run_hostloop_fleet(s, n, plants=p)[1]["final_x"])
                for s, p in zip(scs, (lanes64.to(DEVICE, torch.float32), lanes64))]
        vfid = float(np.abs(fids[0] - fids[1]).max())
        rec["variant"] = {**var["kwargs"], "lanes": n, "max_abs_dfid": vfid, "bound": var["tol"],
                          "fidelity_min": float(fids[0].min()),
                          "fidelity_spread": float(np.ptp(fids[0]))}
        require(vfid <= var["tol"], f"{name} {var['kwargs']}: lanes differ from the float64 "
                                    f"CPU path: {rec}")
    emit(rec)
    require(float(dfid.max()) <= bound and codes_equal,
            f"{name}: first {lanes} lanes differ from the float64 CPU path: {rec}")
    return rec, fleet_fidelity(sc64, out64["final_x"]), out64["exit_code"]


def fleet_preset(presets, name):
    """The preset's constructor with the fleet's own arguments (not_gate's
    step count, cnot's order)."""
    return functools.partial(presets.PRESETS[name], **FLEETS[name].get("kwargs", {}))


def phase_rescue(presets, run_hostloop_fleet, fleet_fidelity, counters) -> dict:
    """The rescue pass on the card (RESCUE): a short cnot run at order 2 in
    which every lane is marginal, re-run at order 3 on a padded batch. The
    main pass's and the rescue's launches are counted apart, and the kept
    states are held against the same call on the float64 CPU path."""
    lanes, steps = RESCUE["lanes"], RESCUE["steps"]
    cut = lambda s: dataclasses.replace(s, config=dataclasses.replace(s.config, n_steps=steps))
    cpu = dict(device="cpu", dtype=torch.float64)
    make = presets.cnot_state
    plants64 = make_lanes(make(**cpu).plant, lanes)
    for fn in counters.values():
        fn.launches = 0
    m, out = run_hostloop_fleet(cut(make(order=2)), lanes,
                                plants=plants64.to(DEVICE, torch.float32),
                                rescue={"threshold": 2.0, "scenario": cut(make(order=3))})
    total = {k: fn.launches for k, fn in counters.items()}
    m64, out64 = run_hostloop_fleet(cut(make(order=2, **cpu)), lanes, plants=plants64,
                                    rescue={"threshold": 2.0,
                                            "scenario": cut(make(order=3, **cpu))})
    sc64 = make(**cpu)
    dfid = float(np.abs(fleet_fidelity(sc64, out["final_x"])
                        - fleet_fidelity(sc64, out64["final_x"])).max())
    pad = 1 << (lanes - 1).bit_length()
    rec = {"phase": "rescue", "preset": "cnot_state", "lanes": lanes, "steps": steps,
           **{k: m[k] for k in ("rescued_lanes", "rescue_batch", "rescue_improved", "rescue_s",
                                "rescue_launches", "fidelity_min", "completed_frac")},
           "launches_main": {k: total[k] - m["rescue_launches"][k] for k in total},
           "cpu_rescue_improved": m64["rescue_improved"], "max_abs_dfid": dfid,
           "bound": RESCUE["tol"]}
    emit(rec)
    require((m["rescued_lanes"], m["rescue_batch"]) == (lanes, pad),
            f"rescue gathered {m['rescued_lanes']} lanes into {m['rescue_batch']}: {rec}")
    require(rec["launches_main"] == RESCUE["launches"]
            and m["rescue_launches"] == RESCUE["launches"],
            f"rescue launches, expected {RESCUE['launches']} a pass: {rec}")
    # a lane keeps the better of two results, so its fidelity is held; which
    # of the two it kept may differ where they are within rounding
    require(m["completed_frac"] == 1.0 and dfid <= RESCUE["tol"],
            f"rescue differs from the float64 CPU path: {rec}")
    return rec


def expected_launches(runner, sc, n_steps: int) -> dict:
    """The kernel launches one run of `runner` on scenario `sc` makes, from
    its budgets: one expm_small a step (plant step), and a QP kernel a warm
    SQP iteration (warm_sqp_iters a warm step) and a steady step,
    boxqp_small once a solve, admm_big once a rho round and ns_cold once a
    rho round of a cold "ns" K^-1 that it takes; condense_small once an SQP
    iteration where the runner's rule sends the model phase to it."""
    from mpc4quantum_tpu_torch.kernels.nsinv import MAX_N, MIN_N
    from mpc4quantum_tpu_torch.mpc.driver import bilinear_model

    cfg = runner.config
    n_warm = min(2, n_steps) if cfg.warm_start else n_steps
    warm = sum(runner.warm_sqp_iters[min(s, len(runner.warm_sqp_iters) - 1)]
               for s in range(n_warm))
    steady = n_steps - n_warm
    route = runner.condense_route(bilinear_model(sc.model, cfg), sc.x0.dtype,
                                  torch.device(DEVICE))
    condense = warm + steady if route == "kernel" else 0
    if runner.qp_kernel == "small":
        return {"boxqp_small": warm + steady, "expm_small": n_steps, "admm_big": 0,
                "condense_small": condense, "ns_cold": 0}
    require(not runner.carry_kinv, "expected_launches counts runs without the K^-1 carry")
    # a cold "ns" chain of a float32 K, n within ns_cold's sizes
    n = cfg.horizon * cfg.dim_u
    cold = lambda p: int(p.kinv == "ns" and sc.plant.real_dtype == torch.float32
                         and MIN_N <= n <= MAX_N) * p.n_rounds
    return {"boxqp_small": 0, "expm_small": n_steps,
            "admm_big": warm * cfg.qp_params.n_rounds
            + steady * runner.steady_qp_params.n_rounds, "condense_small": condense,
            "ns_cold": warm * cold(cfg.qp_params) + steady * cold(runner.steady_qp_params)}


def phase_bench_entry(bench, presets, make_runner, counters, flagship: dict) -> dict:
    """bench_torch.main() at its defaults, in this process so the kernels'
    build is reused: the flagship at B 16384 and the six presets on the
    card in float32. Its one JSON line, its gates, the card's name, and each
    kernel's launches against what the runners' budgets give
    (expected_launches a run, times the entry's runs, plus cnot's rescue
    pass as the entry point reports it)."""
    for fn in counters.values():
        fn.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = bench.main(env={})
    launches = {k: fn.launches for k, fn in counters.items()}
    lines = printed.getvalue().strip().splitlines()
    presets_res = res["presets"]
    sc, plants = bench.flagship(4, DEVICE, torch.float32)
    runners = {"flagship": (make_runner(sc, plants, **bench.flagship_overrides(sc)), sc,
                            1 + bench.DEFAULT_REPS)}
    for name, (_, kw, _) in bench.PRESET_SPEC.items():
        sc = presets.PRESETS[name](**kw)
        runners[name] = (make_runner(sc, make_lanes(sc.plant, 4)), sc, bench.PRESET_REPS)
    expected = dict.fromkeys(counters, 0)
    for name, (runner, sc, runs) in runners.items():
        rescue = presets_res.get(name, {}).get("rescue_launches", {})
        for k, v in expected_launches(runner, sc, sc.config.n_steps).items():
            expected[k] += v * runs + rescue.get(k, 0)
    headline = ("device", "power_limit", "batch", "value", "unit", "fidelity_mean",
                "fidelity_min", "completed_frac", "compile_s", "vs_baseline",
                "baseline_cpu_s_per_rollout", "calib_chain_ms", "calib_dispatch_ms",
                "preset_gates_ok")
    per_preset = ("batch", "rollouts_per_s", "rollouts_per_s_median", "first_run_s",
                  "fidelity_mean", "fidelity_min", "exit_early_frac", "rescued_lanes",
                  "rescue_s", "gate_failed")
    rec = {"phase": "bench_entry", **{k: res[k] for k in headline},
           "chip_smoke_flagship_rollouts_per_s": flagship["rollouts_per_s"],
           "presets": {n: {k: m.get(k) for k in per_preset} for n, m in presets_res.items()},
           "launches": launches, "expected_launches": expected}
    emit(rec)
    require(len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(res)),
            f"bench_entry printed {len(lines)} lines, not its one JSON line")
    require(res["device"] == torch.cuda.get_device_name(0),
            f"bench_entry ran on {res['device']}, not {torch.cuda.get_device_name(0)}")
    require(list(presets_res) == list(bench.PRESET_SPEC) and res["preset_gates_ok"],
            f"bench_entry preset gates: {rec}")
    require(all(m["completed_frac"] == 1.0 and m["qp_fail_frac"] == 0.0
                for m in presets_res.values()), f"bench_entry preset lanes failed: {rec}")
    require(presets_res["not_gate"]["exit_early_frac"] == 1.0,
            f"bench_entry not_gate lanes did not all exit early: {rec}")
    require(res["fidelity_mean"] > 0.98 and res["fidelity_min"] > 0.95
            and res["completed_frac"] >= 0.999, f"bench_entry flagship gates: {rec}")
    require(launches == expected, f"bench_entry kernel launches {launches}, expected {expected}")
    return rec


def phase_slice_fleet(name, make, make_runner, run_hostloop_fleet, fleet_fidelity,
                      counters) -> dict:
    """One of SLICE_FLEETS on the card in float32 (a warm-up run, then the
    timed run), its gates and launches, and its first lanes over the first
    steps against the float64 CPU run on the same plants (and, with
    `tracking`, over its first steps to a tighter bound)."""
    spec = SLICE_FLEETS[name]
    B, reps = spec["batch"], spec["reps"]
    sc, sc64 = make(DEVICE, torch.float32), make("cpu", torch.float64)
    plants64 = make_lanes(sc64.plant, B)
    plants = plants64.to(DEVICE, torch.float32)
    per_run = expected_launches(make_runner(sc, plants), sc, sc.config.n_steps)
    for fn in counters.values():
        fn.launches = 0
    metrics, out = run_hostloop_fleet(sc, B, plants=plants, reps=reps)
    launches = {k: fn.launches for k, fn in counters.items()}
    fid = fleet_fidelity(sc, out["final_x"])
    lanes, steps = spec["parity_lanes"], spec["parity_steps"]
    cut = lambda s: dataclasses.replace(s, config=dataclasses.replace(s.config, n_steps=steps))
    for fn in counters.values():
        fn.launches = 0
    _, out_s = run_hostloop_fleet(cut(sc), lanes, plants=plants[:lanes])
    parity_launches = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    _, out64 = run_hostloop_fleet(cut(sc64), lanes, plants=plants64[:lanes])
    dfid = np.abs(fleet_fidelity(sc, out_s["final_x"]) - fleet_fidelity(sc64, out64["final_x"]))
    parity = {"lanes": lanes, "steps": steps, "max_abs_dfid": float(dfid.max()),
              "bound": spec["parity_tol"], "cpu_s": time.perf_counter() - t0,
              "exit_codes_equal": bool((out_s["exit_code"].cpu() == out64["exit_code"]).all()),
              "launches": parity_launches}
    if "tracking" in spec:
        t_steps, t_tol = spec["tracking"]
        cut_t = lambda s: dataclasses.replace(s, config=dataclasses.replace(s.config,
                                                                            n_steps=t_steps))
        for fn in counters.values():
            fn.launches = 0
        _, out_t = run_hostloop_fleet(cut_t(sc), lanes, plants=plants[:lanes])
        parity["launches"] = {k: parity["launches"][k] + fn.launches
                              for k, fn in counters.items()}
        _, out_t64 = run_hostloop_fleet(cut_t(sc64), lanes, plants=plants64[:lanes])
        dt_fid = np.abs(fleet_fidelity(sc, out_t["final_x"])
                        - fleet_fidelity(sc64, out_t64["final_x"]))
        parity["tracking"] = {"steps": t_steps, "max_abs_dfid": float(dt_fid.max()),
                              "bound": t_tol}
    rec = {"phase": "slice_fleet", "gpu": smi_line(), **metrics, "runs": reps,
           "launches": launches, "launches_a_run": per_run,
           "n_qp": sc.config.horizon * sc.config.dim_u, "state_dim": int(sc.x0.shape[0]),
           "fidelity_median": float(np.median(fid)), "parity": parity}
    emit(rec)
    require(tuple(out["final_x"].shape) == (B, sc.x0.shape[0])
            and bool(torch.isfinite(out["final_x"]).all()), f"{name}: final states not finite")
    require(launches == {k: v * reps for k, v in per_run.items()},
            f"{name} kernel launches over {reps} runs: {launches}, expected {per_run} a run")
    require(metrics["completed_frac"] == 1.0 and metrics["qp_fail_frac"] == 0.0,
            f"{name} fleet lanes failed: {metrics}")
    require(parity["exit_codes_equal"] and parity["max_abs_dfid"] <= parity["bound"],
            f"{name}: first {lanes} lanes differ from the float64 CPU run: {parity}")
    if "tracking" in parity:
        require(parity["tracking"]["max_abs_dfid"] <= parity["tracking"]["bound"],
                f"{name}: the first steps differ from the float64 CPU run: {parity}")
    return rec


def learned_scenario(presets, dmdc, kind: str, **kw):
    """not_state with a per-lane model refit every step: (scenario, refit)."""
    sc = presets.not_state(**kw)
    A = sc.model.A
    dim_u = A.shape[1] - 4
    if kind == "online":
        model = dmdc.online_from_bootstrap(A, 4, 4, dim_u, alpha=LEARN["alpha"])
        fit = dmdc.online_fit_iteration
    else:
        model = dmdc.discrep_bootstrap(A, 4, 4, dim_u, capacity=DISCREP["capacity"],
                                       rcond=DISCREP["rcond"])
        fit = dmdc.discrep_fit_iteration
    cfg = dataclasses.replace(sc.config, streaming=True)
    return dataclasses.replace(sc, model=model, config=cfg), fit


def phase_learned_fleet(kind, presets, dmdc, run_hostloop_fleet, fleet_fidelity, counters,
                        flagship) -> dict:
    """A learned-model fleet (LEARN: "online", DISCREP: "discrep") through
    run_hostloop_fleet on the card in float32, recorded, with its gates and
    launch counts, and its first lanes again in float64 on the CPU with the
    same noise."""
    spec = LEARN if kind == "online" else DISCREP
    B, sigma = spec["batch"], spec.get("sigma", 0.0)
    sc, fit = learned_scenario(presets, dmdc, kind)
    plants64 = make_lanes(presets.not_state(device="cpu", dtype=torch.float64).plant, B)
    plants64 = dataclasses.replace(plants64, sigma=plants64.sigma + sigma)
    noise = None
    g = torch.Generator(device=DEVICE).manual_seed(7)
    if sigma:
        draw = lambda: torch.randn((sc.config.n_steps, B, 4), generator=g, device=DEVICE)
        noise = torch.complex(draw(), draw())
    for fn in counters.values():
        fn.launches = 0
    metrics, out = run_hostloop_fleet(sc, B, plants=plants64.to(DEVICE, torch.float32),
                                      reps=FLEET_REPS, record=True, noise=noise,
                                      model_update_fn=fit)
    launches = {k: fn.launches for k, fn in counters.items()}
    probe = None
    if "probe_sigma" in spec:
        lanes = spec["probe_lanes"]
        noisier = dataclasses.replace(plants64[:lanes],
                                      sigma=plants64.sigma[:lanes] - sigma + spec["probe_sigma"])
        m, o = run_hostloop_fleet(sc, lanes, plants=noisier.to(DEVICE, torch.float32),
                                  generator=g, model_update_fn=fit)
        f = fleet_fidelity(sc, o["final_x"])
        probe = {"sigma": spec["probe_sigma"], "lanes": lanes,
                 "completed_frac": m["completed_frac"],
                 "fidelity_mean": float(f.mean()), "fidelity_min": float(f.min()),
                 "lanes_below_gate": int((f <= spec["fid_lane"]).sum())}
    fid = fleet_fidelity(sc, out["final_x"])
    A_end = out["model_state"].A
    moved = float((A_end - sc.model.A).abs().amax())
    rec = {"phase": f"{'learn' if kind == 'online' else 'discrep'}_fleet", **metrics,
           "wall_s": B / metrics["rollouts_per_s"], "sigma": sigma, "launches": launches,
           "runs": FLEET_REPS, "gates": {k: spec[k] for k in ("fid_lane", "fid_mean")},
           "rate_vs_flagship": metrics["rollouts_per_s"] / flagship["rollouts_per_s"],
           "lanes_below_gate": int((fid <= spec["fid_lane"]).sum()), "max_abs_dA": moved}
    if probe is not None:
        rec["ungated_probe"] = probe
    if kind == "discrep":
        rec["count"] = sorted(set(out["model_state"].count.tolist()))
    n_steps = sc.config.n_steps
    require(tuple(out["xs"].shape) == (B, 4, n_steps + 1) and bool(torch.isfinite(out["xs"]).all())
            and bool((out["n_valid"] == n_steps).all()), f"{kind}: record {rec}")
    # the first lanes in float64 on the CPU, the same noise copied to the host
    lanes = spec["parity_lanes"]
    sc64, _ = learned_scenario(presets, dmdc, kind, device="cpu", dtype=torch.float64)
    noise64 = None if noise is None else noise[:, :lanes].cpu().to(torch.complex128)
    _, out64 = run_hostloop_fleet(sc64, lanes, plants=plants64[:lanes], record=True,
                                  noise=noise64, model_update_fn=fit)
    fid64 = fleet_fidelity(sc64, out64["final_x"])
    dfid = np.abs(fid[:lanes] - fid64)
    rec["lane_parity"] = {"lanes": lanes, "max_abs_dfid": float(dfid.max()),
                          "bound": spec["parity_tol"], "fidelity_mean_f64": float(fid64.mean()),
                          "fidelity_mean": float(fid[:lanes].mean()),
                          "max_abs_dA": float((A_end[:lanes].cpu().to(torch.complex128)
                                               - out64["model_state"].A).abs().max())}
    emit(rec)
    expected = {k: v * FLEET_REPS for k, v in spec["launches"].items()}
    require(launches == expected, f"{kind} launches {launches}, expected {expected}")
    require(metrics["completed_frac"] == 1.0 and metrics["qp_fail_frac"] == 0.0,
            f"{kind} fleet lanes failed: {rec}")
    require(float(fid.min()) > spec["fid_lane"] and float(fid.mean()) >= spec["fid_mean"],
            f"{kind} fleet fidelity below the gates: {rec}")
    require(moved > 1e-10, f"{kind}: the models did not move {rec}")
    if kind == "discrep":
        require(rec["count"] == [min(n_steps, DISCREP["capacity"])], f"discrep count {rec}")
    require(float(dfid.max()) <= spec["parity_tol"], f"{kind}: lanes differ from float64 {rec}")
    return rec


def single_problem(systems, torch_mods, dt, device, dtype):
    """The flagship's single-rollout problem at step dt (horizon 10, 20
    steps), for mpc(): (x0, targets and costs, config, sat)."""
    MPCConfig = torch_mods["MPCConfig"]
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    H, n_steps = 10, 20
    sat = 2 * np.pi * 0.1
    Rx = systems.rx_rotation(1e-4)
    x0 = (Rx @ np.diag([1.0, 0.0]).astype(complex) @ Rx.conj().T).flatten()
    targ = np.diag([0.0, 1.0]).astype(complex).flatten()
    cx = lambda a: torch.tensor(np.asarray(a, complex)).to(device, cdt)
    re = lambda a: torch.tensor(np.asarray(a, float)).to(device, dtype)
    Q = cx(np.diag([1.0, 0, 0, 1]))
    args = (cx(np.tile(targ[:, None], (1, n_steps + H + 1))), re(np.zeros((1, n_steps + H))),
            Q, re(np.eye(1) * (1e-2 / sat ** 2)), Q)
    return cx(x0), args, MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=1, order=2), sat


def damped_chain4_scenario(device, dtype, **kw):
    """presets.damped_chain4_scenario, under the name the benchmark's own
    tests read."""
    from mpc4quantum_tpu_torch import presets

    return presets.damped_chain4_scenario(device, dtype, **kw)


def phase_train_then_control(systems, torch_mods, counters, host_flag) -> dict:
    """The data-driven flow at B = 1: quantum_simulate of a Blackman drive
    (one expm_small launch at B = 48), train_model, then mpc() with the
    learned model on the ideal qubit, its QPs on the default chol backend
    (plain PyTorch: no boxqp_small launch; condense_small once an SQP
    iteration); the same in float64 on the CPU."""
    QuantumPlant, simulate = torch_mods["QuantumPlant"], torch_mods["quantum_simulate"]
    dt, order = 0.25, 2
    ts = np.arange(0, 12.0, dt)
    us_np = systems.blackman(ts, 0, 6.0, dt)[None, :]
    rho0 = np.diag([1.0, 0.0]).astype(complex).flatten()
    powers = torch_mods["control_powers"](order, 1)[1:]
    rec = {"phase": "train_then_control", "steps_simulated": len(ts),
           "gates": {"p1": SINGLE["p1"], "loss": SINGLE["loss"], "vs_cpu": SINGLE["cpu_tol"]}}
    results = {}
    for where, device, dtype in (("card", DEVICE, torch.float32), ("cpu", "cpu", torch.float64)):
        plant = QuantumPlant.create(0.0 * systems.SZ, [0.5 * systems.SX], device=device,
                                     dtype=dtype)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        us = torch.tensor(us_np).to(device, dtype)
        xs = simulate(plant, torch.tensor(rho0).to(device, plant.dtype), us, dt)
        sim_launches = {k: fn.launches for k, fn in counters.items()}
        UL1 = torch_mods["lift_controls"](us, powers)
        model, rcond, losses = torch_mods["train_model"](xs[:, 1:], xs[:, :-1], UL1)
        A = model.A
        mstate = torch_mods["dmdc_from_operator"](A, 4, 4, A.shape[1] - 4)
        x0, args, cfg, sat = single_problem(systems, torch_mods, dt, device, dtype)
        for fn in counters.values():
            fn.launches = 0
        reads = host_flag.reads
        res = torch_mods["mpc"](x0, mstate, plant, *args, cfg, sat, 0.5 * sat)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        results[where] = {"wall_s": time.perf_counter() - t0, "simulate_launches": sim_launches,
                          "min_loss": float(losses.min()), "rcond": rcond,
                          "exit_code": int(res.exit_code), "n_valid": int(res.n_valid),
                          "p1": float(res.xs[3, -1].real), "sqp_iters": batch_iters(res),
                          "host_reads": host_flag.reads - reads,
                          "mpc_launches": {k: fn.launches for k, fn in counters.items()}}
    rec.update(results)
    rec["p1_gap_vs_cpu"] = abs(results["card"]["p1"] - results["cpu"]["p1"])
    emit(rec)
    card = results["card"]
    require(card["simulate_launches"] == {"boxqp_small": 0, "expm_small": 1, "admm_big": 0,
                                          "condense_small": 0, "ns_cold": 0},
            f"train_then_control: quantum_simulate launches {rec}")
    require(card["exit_code"] == 0 and card["p1"] > SINGLE["p1"]
            and card["min_loss"] < SINGLE["loss"], f"train_then_control gates: {rec}")
    require(card["mpc_launches"] == with_condense(SINGLE["chol_launches"], card["sqp_iters"]),
            f"train_then_control: mpc() launches (the chol default) {rec}")
    require(rec["p1_gap_vs_cpu"] <= SINGLE["cpu_tol"], f"train_then_control vs cpu {rec}")
    return rec


def phase_observe_eops(systems, torch_mods, counters, host_flag) -> dict:
    """mpc() on the 1%-detuned qubit observed through the Pauli e_ops at
    sigma 1e-4 (quantum_observe), noise drawn on the card; the same noise
    in float64 on the CPU. Run on the default chol backend and once on the
    kernel route (qp_backend="ns"), which launches boxqp_small at B = 1
    once an SQP iteration; condense_small once an SQP iteration on both."""
    QuantumPlant = torch_mods["QuantumPlant"]
    wq = 2 * np.pi * 4
    paulis = [np.eye(2, dtype=complex), systems.SX, systems.SY, systems.SZ]
    base = QuantumPlant.create(0.5 * (wq * 0.99 - wq) * systems.SZ, [0.5 * systems.SX],
                               sigma=1e-4, e_ops=paulis, device="cpu", dtype=torch.float64)
    g = torch.Generator(device=DEVICE).manual_seed(11)
    draw = lambda: torch.randn((20, 4), generator=g, device=DEVICE)
    noise = torch.complex(draw(), draw())
    rec = {"phase": "observe_eops", "sigma": 1e-4,
           "gates": {"p1": SINGLE["p1"], "vs_cpu": SINGLE["cpu_tol"]}}
    for backend in ("chol", "ns"):
        for where, device, dtype in (("card", DEVICE, torch.float32), ("cpu", "cpu", torch.float64)):
            plant = base.to(device, dtype)
            x0, args, cfg, sat = single_problem(systems, torch_mods, 1.0, device, dtype)
            cfg = dataclasses.replace(cfg, qp_backend=backend)
            sc = torch_mods["presets"].not_state(device=device, dtype=dtype)
            for fn in counters.values():
                fn.launches = 0
            reads = host_flag.reads
            t0 = time.perf_counter()
            res = torch_mods["mpc"](x0, sc.model, plant, *args, cfg, sat, 0.5 * sat,
                                    noise=noise.to(device, plant.dtype),
                                    observe_fn=torch_mods["quantum_observe"])
            rec[f"{where}_{backend}"] = {
                "wall_s": time.perf_counter() - t0, "exit_code": int(res.exit_code),
                "n_valid": int(res.n_valid), "p1": float(res.xs[3, -1].real),
                "sqp_iters": int(res.sqp_iters.sum()), "host_reads": host_flag.reads - reads,
                "launches": {k: fn.launches for k, fn in counters.items()}}
        rec[f"p1_gap_vs_cpu_{backend}"] = abs(rec[f"card_{backend}"]["p1"]
                                              - rec[f"cpu_{backend}"]["p1"])
    emit(rec)
    for backend in ("chol", "ns"):
        card = rec[f"card_{backend}"]
        require(card["exit_code"] == 0 and card["p1"] > SINGLE["p1"],
                f"observe_eops {backend} gates: {rec}")
        require(rec[f"p1_gap_vs_cpu_{backend}"] <= SINGLE["cpu_tol"],
                f"observe_eops {backend} vs cpu {rec}")
    chol = rec["card_chol"]
    require(chol["launches"] == with_condense(SINGLE["chol_launches"], chol["sqp_iters"]),
            f"observe_eops chol launches {rec}")
    # the kernel route: one boxqp_small launch an SQP iteration
    ns = rec["card_ns"]
    require(ns["launches"] == {"boxqp_small": ns["sqp_iters"], "expm_small": 20, "admm_big": 0,
                               "condense_small": ns["sqp_iters"], "ns_cold": 0},
            f"observe_eops ns launches {rec}")
    return rec


def run_cli(cli_main, argv) -> tuple:
    """`python -m mpc4quantum_tpu_torch` in this process: (its one JSON
    line, what it wrote to stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    lines = out.getvalue().strip().splitlines()
    require(rc == 0 and len(lines) == 1, f"CLI {argv}: rc {rc}, output {lines}, {err.getvalue()}")
    return json.loads(lines[0]), err.getvalue()


def counted(counters, host_flag, fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, the launches, the host reads)."""
    for c in counters.values():
        c.launches = 0
    reads = host_flag.reads
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}, host_flag.reads - reads


def phase_cli_rollout(cli_main, counters, host_flag) -> dict:
    """One rollout of the flagship through the CLI on the card (the chol
    QP), against its --cpu run in float64."""
    (card, _), launches, reads = counted(counters, host_flag,
                                         lambda: run_cli(cli_main, ["not_state"]))
    cpu, _ = run_cli(cli_main, ["not_state", "--cpu"])
    rec = {"phase": "cli_rollout", "card": card, "cpu": cpu, "launches": launches,
           "host_reads": reads, "wall_s": card["elapsed_s"],
           "fidelity_gap_vs_cpu": abs(card["fidelity"] - cpu["fidelity"]),
           "gates": {"fidelity": CLI["fid"], "vs_cpu": CLI["cpu_tol"]}}
    emit(rec)
    require(set(card) == {"preset", "elapsed_s", "exit_code", "n_valid", "fidelity",
                          "mean_sqp_iters"}, f"cli_rollout keys {rec}")
    require(card["exit_code"] == 0 and card["n_valid"] == 20 and card["fidelity"] > CLI["fid"],
            f"cli_rollout gates {rec}")
    # mean_sqp_iters, to 2 decimals, of 20 steps: their sum exactly
    iters = round(card["mean_sqp_iters"] * card["n_valid"])
    require(launches == with_condense(CLI["launches"], iters), f"cli_rollout launches {rec}")
    require(rec["fidelity_gap_vs_cpu"] <= CLI["cpu_tol"], f"cli_rollout vs cpu {rec}")
    return rec


def lqr_step0(sc) -> tuple:
    """The LQR of the scenario's first step, unclipped: the model
    linearized along the guess repeat(lift(x0)) with zero controls (as
    lqr_seed_guess takes it), the backward value iteration and the
    rollout. :return: (gains (H, dim_u, dim_x+1), U (dim_u, H)) in float64
    on the CPU."""
    from mpc4quantum_tpu_torch.mpc.driver import bilinear_model
    from mpc4quantum_tpu_torch.ops.bilinear import model_along_traj
    from mpc4quantum_tpu_torch.solvers.lqr import lqr_quad_program

    cfg, H = sc.config, sc.config.horizon
    lx0 = sc.plant.lift(sc.x0[None])
    Xg = lx0[:, :, None].expand(-1, -1, H)
    Ug = torch.zeros((1, cfg.dim_u, H), dtype=sc.plant.real_dtype, device=lx0.device)
    A_s, B_s, D_s = model_along_traj(bilinear_model(sc.model, cfg), Xg, Ug)
    Q_s = torch.cat([sc.Q.expand(H, -1, -1), sc.Qf[None]], dim=0)
    res = lqr_quad_program(lx0, sc.X_targ[:, :H + 1], sc.U_targ[:, :H], Q_s,
                           sc.R.expand(H, -1, -1), A_s, B_s, sat=None, Delta_s=D_s)
    return res.gains[0].cpu().to(torch.complex128), res.U[0].cpu().double()


def phase_cli_lqr(cli_main, presets, mpc, counters, host_flag) -> dict:
    """--solver lqr through the CLI on the card, and the same rollout
    through mpc() on the card and in float64 on the CPU for its controls;
    the first step's LQR gains and unclipped controls on the card against
    float64 on the CPU on the same inputs."""
    (card, _), launches, reads = counted(
        counters, host_flag, lambda: run_cli(cli_main, ["not_state", "--solver", "lqr"]))
    runs = {}
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        sc = presets.not_state(device=device)
        sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, solver="lqr"))
        res = mpc(**sc.mpc_args())
        runs[where] = (res.us.detach().cpu().double(), float(res.xs[3, -1].real), sc.sat,
                       lqr_step0(sc))
    (us, p1, sat, (K, U0)), (us64, p1_64, _, (K64, U064)) = runs["card"], runs["cpu"]
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    k = CLI["lqr_close_steps"]
    rec = {"phase": "cli_lqr", "card": card, "launches": launches, "host_reads": reads,
           "mpc_p1": p1, "cpu_p1": p1_64, "max_abs_u": float(us.abs().max()), "sat": sat,
           f"max_du_first_{k}": float((us[:, :k] - us64[:, :k]).abs().max()),
           "max_du": float((us - us64).abs().max()),
           "step0_gain_rel": rel(K, K64), "step0_u_rel": rel(U0, U064),
           "step0_max_abs_u": float(U064.abs().max()),
           "gates": {"p1_card": CLI["lqr_p1_f32"], "p1_cpu_f64": SINGLE["p1"],
                     "du_first_steps": CLI["lqr_close_tol"],
                     "step0_rel": CLI["lqr_step0_rtol"]}}
    emit(rec)
    require(card["exit_code"] == 0 and card["n_valid"] == 20
            and card["fidelity"] > CLI["lqr_p1_f32"] and p1 > CLI["lqr_p1_f32"]
            and p1_64 > SINGLE["p1"], f"cli_lqr gates {rec}")
    require(rec["max_abs_u"] <= sat * (1 + CLI["sat_rtol"]), f"cli_lqr controls leave sat {rec}")
    require(rec[f"max_du_first_{k}"] <= CLI["lqr_close_tol"], f"cli_lqr vs cpu {rec}")
    # the step-0 controls lie inside the box, so this holds the gain solve
    # where no clip can hide it
    require(rec["step0_max_abs_u"] < sat and rec["step0_gain_rel"] <= CLI["lqr_step0_rtol"]
            and rec["step0_u_rel"] <= CLI["lqr_step0_rtol"], f"cli_lqr step-0 LQR vs cpu {rec}")
    require(launches == with_condense(CLI["launches"], 0), f"cli_lqr launches {rec}")
    return rec


def phase_cli_batch(cli_main, presets, batched_mpc, fleet_fidelity, counters,
                    host_flag) -> dict:
    """--batch 1024 through the CLI on the card (batched_mpc, chol); the
    same batch through batched_mpc (its SQP iterations, one condense_small
    launch each); its first lanes again through batched_mpc on the card and
    in float64 on the CPU."""
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    B, lanes = CLI["batch"], CLI["parity_lanes"]
    (card, _), launches, reads = counted(
        counters, host_flag, lambda: run_cli(cli_main, ["not_state", "--batch", str(B)]))
    # the CLI's plants: its detuning and its default seed, 1
    sc = presets.not_state()
    plants = make_scenario_batch(sc.plant, B, detune_scale=0.01,
                                 generator=torch.Generator().manual_seed(1))
    direct, direct_launches, _ = counted(counters, host_flag, lambda: batched_mpc(
        sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, sc.config, sc.sat,
        du=sc.du, exit_condition=sc.exit_condition))
    fids = {}
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        sc = presets.not_state(device=device)
        plants = make_lanes(presets.not_state(device="cpu").plant, B)[:lanes]
        res = batched_mpc(sc.x0, sc.model, plants.to(device, sc.plant.real_dtype), sc.X_targ,
                          sc.U_targ, sc.Q, sc.R, sc.Qf, sc.config, sc.sat, du=sc.du)
        fids[where] = fleet_fidelity(sc, res.xs[:, :, -1])
    dfid = np.abs(fids["card"] - fids["cpu"])
    rec = {"phase": "cli_batch", "card": card, "launches": launches, "host_reads": reads,
           "direct_launches": direct_launches, "sqp_iters": batch_iters(direct),
           "rollouts_per_s": card["rollouts_per_s"], "parity_lanes": lanes,
           "max_abs_dfid": float(dfid.max()),
           "gates": {"fidelity_min": CLI["batch_fid_min"], "vs_cpu": CLI["cpu_tol"]}}
    emit(rec)
    require(card["completed_frac"] == 1.0 and card["fidelity_min"] > CLI["batch_fid_min"],
            f"cli_batch gates {rec}")
    require(launches == direct_launches == with_condense(CLI["launches"], rec["sqp_iters"]),
            f"cli_batch launches {rec}")
    require(float(dfid.max()) <= CLI["cpu_tol"], f"cli_batch vs cpu {rec}")
    return rec


def phase_fleet_checkpoint(cli_main, presets, fleet_runner, make_runner, counters,
                           host_flag) -> dict:
    """The flagship fleet (B = 16384) through `--hostloop --checkpoint P
    --checkpoint-every 5`, then a recorded fleet-runner run that crashes
    after step 9 (run eagerly, where the advance is Python), resumed from
    its checkpoint on the captured steps and held against the uninterrupted
    run with torch.equal."""
    every, crash = CLI["ckpt_every"], CLI["crash_step"]
    spec = FLEETS["not_state"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "fleet.npz")
        argv = ["not_state", "--batch", str(spec["batch"]), "--hostloop", "--checkpoint", path,
                "--checkpoint-every", str(every), "--progress-every", str(every)]
        (card, err), launches, _ = counted(counters, host_flag, lambda: run_cli(cli_main, argv))
        cli_left = os.path.exists(path)
        sc = presets.not_state()
        plants = make_lanes(presets.not_state(device="cpu").plant,
                            spec["batch"]).to(DEVICE, sc.plant.real_dtype)
        runner = make_runner(sc, plants)
        args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)
        full = runner.run(*args, record=True)
        orig, calls = fleet_runner.advance, {"n": 0}

        def crashing(*a, **k):
            calls["n"] += 1
            if calls["n"] == crash + 1:
                raise RuntimeError("simulated crash")
            return orig(*a, **k)
        fleet_runner.advance = crashing
        # the crash is raised in the eager advance: a replayed step calls no Python
        runner._graphs = False
        try:
            runner.run(*args, record=True, checkpoint_path=path, checkpoint_every=every)
            crashed = False
        except RuntimeError:
            crashed = True
        finally:
            fleet_runner.advance = orig
            runner._graphs = True
        saved_s = list(runner.checkpoint_seconds)
        kept = os.path.exists(path)
        resumed, resumed_launches, _ = counted(
            counters, host_flag,
            lambda: runner.run(*args, record=True, checkpoint_path=path,
                               checkpoint_every=every))
        left = os.path.exists(path)
    keys = ("final_x", "exit_code", "xs", "us", "objs", "sqp_iters", "n_valid")
    equal = {k: bool(torch.equal(resumed[k], full[k])) for k in keys}
    rec = {"phase": "fleet_checkpoint", "batch": spec["batch"], "every": every,
           "cli": {k: card[k] for k in ("rollouts_per_s", "first_run_s", "fidelity_min",
                                        "completed_frac", "checkpoint_s")},
           "launches": launches, "heartbeats": err.count("[fleet] step"),
           "checkpoint_s": saved_s, "crashed_after_step": crash - 1,
           "resumed_launches": resumed_launches, "resumed_equal": equal,
           "checkpoint_left": {"cli": cli_left, "after_crash": kept, "after_resume": left}}
    emit(rec)
    require(launches == spec["launches"], f"fleet_checkpoint launches {rec}")
    require(card["completed_frac"] == 1.0 and card["fidelity_min"] >= spec["fid_min"]
            and len(card["checkpoint_s"]) == 3 and rec["heartbeats"] == 3,
            f"fleet_checkpoint CLI run {rec}")
    require(crashed and kept and not cli_left and not left, f"fleet_checkpoint files {rec}")
    require(all(equal.values()), f"fleet_checkpoint: resumed != uninterrupted {rec}")
    steady = sc.config.n_steps - crash
    require(resumed_launches == {"boxqp_small": steady, "expm_small": steady, "admm_big": 0,
                                 "condense_small": steady, "ns_cold": 0},
            f"fleet_checkpoint resumed launches {rec}")
    return rec


def phase_chol_qp(solve_boxqp, BoxQPParams, boxqp_mod, host_flag) -> dict:
    """solve_boxqp alone on the flagship's shape (B 16384, n 10, cold, the
    library's 2x150) against its float64 solve of the same QPs on the CPU,
    and boxqp_small 3x12 on them beside it; where the solve synchronizes
    with the host (PyTorch's sync debug mode, by source line)."""
    P, q, lb, ub = qp_batch(BATCH, 10, seed=21)
    params = BoxQPParams()
    ms = cuda_ms(lambda: solve_boxqp(P, q, lb, ub, params=params), reps=3)
    reads = host_flag.reads
    # every synchronizing call PyTorch makes in a (warm) solve, by its sync
    # debug mode, counted by the Python line that made it: the host's reads
    # of the done flags are utils/profiling.py's; reported, not gated
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = solve_boxqp(P, q, lb, ub, params=params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    reads = host_flag.reads - reads
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    res64 = solve_boxqp(*(t.cpu().double() for t in (P, q, lb, ub)), params=params)
    both = res.converged.cpu() & res64.converged
    dz = ((res.x.cpu().double() - res64.x).abs().amax(dim=1)
          / torch.clamp(res64.x.abs().amax(dim=1), min=1.0))
    diters = (res.iters.cpu() - res64.iters).abs()
    rec = {"phase": "chol_qp", "B": BATCH, "n": 10, "gpu": smi_line(), "ms": ms,
           "host_reads": reads, "sync_sites": sites,
           "iters_mean": float(res.iters.float().mean()),
           "iters_max": int(res.iters.max()), "iters_mean_f64": float(res64.iters.float().mean()),
           "iters_equal_frac": float((diters == 0).float().mean()),
           "iters_max_abs_diff": int(diters.max()),
           "accepted_frac": float(res.converged.float().mean()),
           "accepted_frac_f64": float(res64.converged.float().mean()),
           "max_dz_rel_both_accepted": float(dz[both].max()),
           "boxqp_small_3x12_ms": cuda_ms(lambda: boxqp_mod.boxqp_small(P, q, lb, ub, iters=12,
                                                                        rounds=3)),
           "gates": {"accepted": CLI["chol_accept"], "dz_rel": QP_TOL}}
    emit(rec)
    require(rec["accepted_frac"] >= CLI["chol_accept"]
            and rec["accepted_frac_f64"] >= CLI["chol_accept"], f"chol_qp acceptance {rec}")
    require(rec["max_dz_rel_both_accepted"] <= QP_TOL, f"chol_qp vs float64 {rec}")

    return rec


def warm_linearization(presets, name, fleet_runner, run_hostloop_fleet, B):
    """The last warm-phase solve of the preset's fleet on B card lanes (a
    2-step run, its quad_program calls recorded): (K (B, n, n) contiguous,
    rho (B,), the real-embedded LQR data, the phase's BoxQPParams)."""
    from mpc4quantum_tpu_torch.solvers.boxqp import warm_rho
    from mpc4quantum_tpu_torch.solvers.condense import qp_data
    from mpc4quantum_tpu_torch.solvers.riccati import embed_costs, embed_ltv

    make = fleet_preset(presets, name)
    sc = make()
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=2))
    plants = make_lanes(make(device="cpu").plant, B).to(DEVICE, torch.float32)
    calls, orig = [], fleet_runner.quad_program

    def record(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    fleet_runner.quad_program = record
    # eagerly: a captured solve's arguments are temporaries of its graphs
    fleet_runner.FleetRunner._graphs = False
    try:
        run_hostloop_fleet(sc, B, plants=plants)
    finally:
        fleet_runner.quad_program = orig
        fleet_runner.FleetRunner._graphs = True
    args, kw = calls[-1]
    x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, D_s, u_prev, sat, du = args
    params = kw["params"]
    P = qp_data(x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, D_s, u_prev, sat, du)[0]
    P = 0.5 * (P + P.transpose(-1, -2))
    diag = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = warm_rho(kw["rho_warm"], params.rho0 * diag, diag)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    K = (P + (params.sigma + rho)[:, None, None] * eye).contiguous()
    lqr = tuple(t.contiguous() for t in embed_ltv(A_s, B_s) + embed_costs(Q_s, R_s))
    return K, rho, lqr, params


def phase_kinv_builds(presets, fleet_runner, run_hostloop_fleet) -> dict:
    """The four K^-1 forms at the large-n fleets' shapes (KINV), plain
    PyTorch on the card: device ms a build (CUDA events, 20 builds after a
    warm-up), the residual and the gap to float64."""
    from mpc4quantum_tpu_torch.solvers.boxqp import ns_inverse
    from mpc4quantum_tpu_torch.solvers.riccati import riccati_kinv_batch
    from mpc4quantum_tpu_torch.utils.linalg import gj_inverse

    rec = {"phase": "kinv_builds", "gpu": smi_line(), "gates": KINV["tol"]}
    for name, B in KINV["fleets"].items():
        K, rho, lqr, params = warm_linearization(presets, name, fleet_runner,
                                                 run_hostloop_fleet, B)
        H, m, du = lqr[1].shape[-3:]
        builds = {"ns": lambda: ns_inverse(K, params.ns_iters), "gj": lambda: gj_inverse(K),
                  "riccati": lambda: riccati_kinv_batch(*lqr, rho, params.sigma),
                  "riccati_pscan": lambda: riccati_kinv_batch(*lqr, rho, params.sigma,
                                                              pscan=True)}
        lanes = KINV["ref_lanes"]
        K64 = K[:lanes].double().cpu().numpy()
        ref = np.linalg.inv(K64)
        eye = torch.eye(K.shape[-1], device=DEVICE)
        cell = {"B": B, "H": int(H), "m": int(m), "du": int(du), "n": int(K.shape[-1]),
                "ns_iters": params.ns_iters,
                "cond_lane0": float(np.linalg.cond(K64[0]))}
        for form in KINV["forms"]:
            X = builds[form]()
            torch.cuda.synchronize()
            resid = float((eye - K @ X).abs().sum(dim=-1).amax())
            gap = float(np.abs(X[:lanes].double().cpu().numpy() - ref).max() / np.abs(ref).max())
            cell[form] = {"ms": cuda_ms(builds[form]), "residual": resid, "gap_f64": gap}
        rec[name] = cell
    emit(rec)
    for name in KINV["fleets"]:
        for form in KINV["forms"]:
            r, tol = rec[name][form], KINV["tol"][form]
            require(r["residual"] <= tol and r["gap_f64"] <= tol,
                    f"kinv_builds {name} {form}: {r}")
    return rec


def phase_kinv_fleet(kind, presets, run_hostloop_fleet, fleet_fidelity, counters, defaults):
    """riccati_fleet (kind "riccati": RICCATI_FLEETS' K-inverse forced) or
    warm_kinv_fleet ("warm_kinv": the steady carry, WARM_KINV_FLEETS' forced
    K-inverse): each fleet with the default phase's launch counts (one
    warm-up and one timed run) and the default run's rate beside it.
    riccati: the default phase's fidelity gates, and 8 lanes against its
    float64 CPU lanes; warm_kinv: 8 lanes against the float64 CPU path of
    the same carried fleet, and the fleet without the carry reported (freq's
    is the default phase's run on the same plants)."""
    from mpc4quantum_tpu_torch.benchfleet import make_runner

    fleets = RICCATI_FLEETS if kind == "riccati" else WARM_KINV_FLEETS
    rec = {"phase": f"{kind}_fleet", "gpu": smi_line()}
    total = dict.fromkeys(counters, 0)
    lanes = 8
    for name, kinv in fleets.items():
        spec, reps = FLEETS[name], 2
        make = fleet_preset(presets, name)
        sc = make()
        plants64 = make_lanes(make(device="cpu").plant, spec["batch"])
        kw = {"kinv": kinv} if kind == "riccati" else {"kinv": kinv, "warm_kinv": True}
        for fn in counters.values():
            fn.launches = 0
        metrics, out = run_hostloop_fleet(sc, spec["batch"],
                                          plants=plants64.to(DEVICE, torch.float32), reps=reps,
                                          rescue=rescue_spec(presets, name), **kw)
        rescued = metrics.get("rescue_launches", {})
        launches = {k: fn.launches - rescued.get(k, 0) for k, fn in counters.items()}
        total = {k: total[k] + launches[k] for k in total}
        default = defaults[name]
        cell = {k: metrics[k] for k in ("rollouts_per_s", "first_run_s", "fidelity_mean",
                                        "fidelity_min", "completed_frac", "qp_fail_frac",
                                        "kinv", "warm_kinv", "kinv_warm_solves",
                                        "kinv_guard_cold")}
        cell.update(launches=launches, runs=reps,
                    default_rollouts_per_s=default["metrics"]["rollouts_per_s"],
                    rate_vs_default=metrics["rollouts_per_s"]
                    / default["metrics"]["rollouts_per_s"],
                    rescued_lanes=metrics.get("rescued_lanes", 0))
        fid = fleet_fidelity(sc, out["final_x"])
        codes = out["exit_code"][:lanes].cpu()
        if kind == "riccati":
            # in float64 the closed loop does not see which inverse ran
            ref, ref_codes = default["fid64"][:lanes], default["codes64"][:lanes]
        else:
            sc64 = make(device="cpu", dtype=torch.float64)
            m64, out64 = run_hostloop_fleet(sc64, lanes, plants=plants64[:lanes], **kw)
            ref, ref_codes = fleet_fidelity(sc64, out64["final_x"]), out64["exit_code"]
            cell["cpu_f64"] = {k: m64[k] for k in ("fidelity_mean", "fidelity_min",
                                                   "qp_fail_frac", "kinv_warm_solves",
                                                   "kinv_guard_cold")}
            if kinv is None and not default["metrics"]["warm_kinv"]:
                # the default phase ran this fleet on these plants without it
                m0, fid0 = default["metrics"], default["fid"]
            else:
                m0, out0 = run_hostloop_fleet(sc, spec["batch"],
                                              plants=plants64.to(DEVICE, torch.float32),
                                              reps=reps, kinv=kinv, warm_kinv=False)
                fid0 = fleet_fidelity(sc, out0["final_x"])
            cell["no_carry"] = {k: m0[k] for k in ("rollouts_per_s", "fidelity_mean",
                                                   "fidelity_min", "qp_fail_frac", "warm_kinv")}
            cell["no_carry"]["max_abs_dfid"] = float(np.abs(fid - fid0).max())
        dfid = np.abs(fid[:lanes] - ref)
        codes_equal = bool(torch.equal(codes, ref_codes.cpu()))
        cell["lane_parity"] = {"lanes": lanes, "max_abs_dfid": float(dfid.max()),
                               "bound": spec["parity_tol"], "exit_codes_equal": codes_equal}
        rec[name] = cell
        expected = {k: v * reps for k, v in spec["launches"].items()}
        # ns_cold: no cold chain under a Riccati K^-1; with the carry, one a
        # rho round but in the steady solves that started from the carry
        rounds = make_runner(sc, plants64[:1].to(DEVICE, torch.float32),
                             **kw).steady_qp_params.n_rounds
        expected["ns_cold"] = 0 if kind == "riccati" else reps * (
            spec["launches"]["admm_big"] - metrics["kinv_warm_solves"] * rounds)
        checks = {"launches": launches == expected,
                  "parity": float(dfid.max()) <= spec["parity_tol"] and codes_equal}
        if kind == "riccati":
            gates = (("fidelity_mean", spec["fid_mean"]), ("fidelity_min", spec["fid_min"]))
            checks.update(completed=metrics["completed_frac"] == 1.0,
                          no_qp_failure=metrics["qp_fail_frac"] == 0.0,
                          fidelity=all(g is None or metrics[k] >= g for k, g in gates))
        else:
            checks.update(carry_engaged=metrics["kinv_warm_solves"] > 0)
        if not all(checks.values()):
            emit(rec)
        require(all(checks.values()), f"{kind}_fleet {name}: {checks} {cell}, "
                                      f"expected launches {expected}")
    rec["launches"] = total
    emit(rec)
    return rec


def batch_iters(res) -> int:
    """The SQP iterations a batch ran (one QP launch each): a step runs
    until its last lane is done, so the most any lane took, summed over the
    steps."""
    iters = res.sqp_iters
    return int(iters.reshape(-1, iters.shape[-1]).amax(dim=0).sum())


def with_condense(launches: dict, iters: int) -> dict:
    """A launch spec with condense_small's count: `iters`, once an SQP
    iteration of a run on its route, or 0 off it."""
    return {**launches, "condense_small": iters}


def vdp_problem(classical, device, dtype, B=None):
    """The Van der Pol Koopman problem (CLASSICAL) on `device` in `dtype`:
    (model, targets and costs, config, the plant or a B-lane batch of it,
    the initial state(s): x0, or B points of the 1.5-radius circle)."""
    c = CLASSICAL
    H, n = c["H"], c["n_steps"]
    t = lambda a: torch.tensor(np.asarray(a, float)).to(device, dtype)
    args = (t(np.zeros((4, n + H + 1))), t(np.zeros((1, n + H))), t(np.diag([1.0, 1, 0, 0])),
            t(np.eye(1) * 1e-2), t(np.diag([1.0, 1, 0, 0])))
    plant = classical.VanDerPol(c["mu"], device=device, dtype=dtype)
    if B is None:
        return args, plant, t(c["x0"])
    phase = np.linspace(0.0, 2 * np.pi, B, endpoint=False)
    x0 = t(c["radius"] * np.stack([np.cos(phase), np.sin(phase)], axis=1))
    return args, dataclasses.replace(plant, param=plant.param.expand(B).clone()), x0


def phase_classical(port, counters, host_flag) -> dict:
    """The Van der Pol Koopman MPC on the card (CLASSICAL): training data by
    rk4_simulate in float64 on the card, train_model, then mpc() on the chol
    default and on the kernel route and batched_mpc at B 1024, in float32;
    8 lanes again in float64 on the CPU. Its states are real: the model
    phase stays plain (no condense_small launch)."""
    from mpc4quantum_tpu_torch.models.dmdc import dmdc_from_operator
    from mpc4quantum_tpu_torch.plants import classical

    c = CLASSICAL
    rng = np.random.default_rng(0)
    us = rng.uniform(-2, 2, size=(1, c["train_steps"]))
    t0 = time.perf_counter()
    plant64 = classical.VanDerPol(c["mu"], device=DEVICE, dtype=torch.float64)
    xs = classical.rk4_simulate(plant64, torch.tensor([1.0, 0.5], dtype=torch.float64,
                                                      device=DEVICE),
                                torch.tensor(us, device=DEVICE), c["dt"])
    zs = classical.vdp_lift(xs.T).T
    model, rcond, losses = port.train_model(zs[:, 1:], zs[:, :-1],
                                            torch.tensor(us, device=DEVICE))
    train_s = time.perf_counter() - t0
    xs_cpu = classical.rk4_simulate(classical.VanDerPol(c["mu"], device="cpu"),
                                    torch.tensor([1.0, 0.5], dtype=torch.float64),
                                    torch.tensor(us), c["dt"])
    A64 = model.A.cpu()
    rec = {"phase": "classical", "gpu": smi_line(), "train_s": train_s, "rcond": rcond,
           "min_loss": float(losses.min()),
           "train_data_gap_vs_cpu": float((xs.cpu() - xs_cpu).abs().max()),
           "gates": {"x_final": c["x_final"], "lane_parity": c["parity_tol"]}}
    cfg = port.MPCConfig(horizon=c["H"], n_steps=c["n_steps"], dt=c["dt"], dim_u=1, order=1)
    mk = lambda A: dmdc_from_operator(A, 4, 4, A.shape[1] - 4)
    model32 = mk(A64.to(DEVICE, torch.float32))
    args, plant, x0 = vdp_problem(classical, DEVICE, torch.float32)
    for backend in ("chol", "ns"):
        cfg_b = dataclasses.replace(cfg, qp_backend=backend)
        t0 = time.perf_counter()
        res, launches, reads = counted(counters, host_flag, lambda: port.mpc(
            x0, model32, plant, *args, cfg_b, c["sat"]))
        rec[f"mpc_{backend}"] = {
            "wall_s": time.perf_counter() - t0, "exit_code": int(res.exit_code),
            "x_final_norm": float(res.xs[:, -1].norm()), "sqp_iters": batch_iters(res),
            "host_reads": reads, "launches": launches}
    B = c["batch"]
    cfg_ns = dataclasses.replace(cfg, qp_backend="ns")
    args, plants, X0 = vdp_problem(classical, DEVICE, torch.float32, B)
    t0 = time.perf_counter()
    res, launches, reads = counted(counters, host_flag, lambda: port.batched_mpc(
        X0, model32, plants, *args, cfg_ns, c["sat"]))
    wall = time.perf_counter() - t0
    xf = res.xs[..., -1].norm(dim=-1)
    lanes = c["parity_lanes"]
    args64, plants64, X064 = vdp_problem(classical, "cpu", torch.float64, B)
    res64 = port.batched_mpc(X064[:lanes], mk(A64), plants64[:lanes], *args64, cfg_ns,
                             c["sat"])
    dx = float((res.xs[:lanes, :, -1].cpu().double() - res64.xs[:, :, -1]).abs().max())
    codes = res.exit_code.cpu()
    rec["batched_ns"] = {"B": B, "wall_s": wall, "rollouts_per_s": B / wall,
                         "launches": launches, "host_reads": reads,
                         "sqp_iters": batch_iters(res),
                         "completed_frac": float(((codes == 0) | (codes == 1)).float().mean()),
                         "share_under_gate": float((xf < c["x_final"]).float().mean()),
                         "x_final_norm_max": float(xf.max()),
                         "lane_parity": {"lanes": lanes, "max_abs_dx_final": dx,
                                         "bound": c["parity_tol"]}}
    emit(rec)
    for backend in ("chol", "ns"):
        r = rec[f"mpc_{backend}"]
        require(r["exit_code"] == 0 and r["x_final_norm"] < c["x_final"],
                f"classical mpc() {backend}: {r}")
        # no expm on a classical plant; the kernel route solves at n = 20
        # through boxqp_big: one admm_big and one (cold) ns_cold launch a rho round
        rounds = cfg.qp_params.n_rounds * r["sqp_iters"] if backend == "ns" else 0
        expected = {"boxqp_small": 0, "expm_small": 0, "admm_big": rounds,
                    "condense_small": 0, "ns_cold": rounds}
        require(r["launches"] == expected, f"classical mpc() {backend} launches, "
                                           f"expected {expected}: {r}")
    b = rec["batched_ns"]
    rec["launches_total"] = {k: sum(r["launches"][k] for r in (rec["mpc_chol"], rec["mpc_ns"], b))
                             for k in counters}
    require(b["completed_frac"] == 1.0 and dx <= c["parity_tol"], f"classical batched: {b}")
    require(b["launches"] == {"boxqp_small": 0, "expm_small": 0,
                              "admm_big": cfg.qp_params.n_rounds * b["sqp_iters"],
                              "condense_small": 0,
                              "ns_cold": cfg.qp_params.n_rounds * b["sqp_iters"]},
            f"classical batched launches: {b}")
    return rec


def phase_embedded(presets, port, counters, host_flag) -> dict:
    """The flagship not_state in the real embedding against the complex
    problem on the kernel route (qp_backend "ns": boxqp_small at n = 10,
    the embedded plant's step one expm_small launch): mpc() at B 1 and
    batched_mpc at B 1024 on detuned lanes. The complex problem's model
    phase runs in condense_small, the embedding's (real states) plainly."""
    from mpc4quantum_tpu_torch.models.dmdc import dmdc_from_operator
    from mpc4quantum_tpu_torch.mpc import embedded

    sc = presets.not_state()
    cfg = dataclasses.replace(sc.config, qp_backend="ns")
    prob, observe = embedded.embed_problem(sc.x0, sc.model.A, sc.X_targ, sc.Q, sc.Qf,
                                           dim_x=4, plant=sc.plant)
    require(observe is None, "embed_problem: the default observation is the runner's")
    model_e = dmdc_from_operator(prob.model_A, 8, 8, prob.model_A.shape[1] - 8)
    B = EMBEDDED["batch"]
    lanes = make_lanes(presets.not_state(device="cpu").plant, B).to(DEVICE, torch.float32)
    runs = {
        "mpc_complex": lambda: port.mpc(sc.x0, sc.model, sc.plant, sc.X_targ, sc.U_targ, sc.Q,
                                        sc.R, sc.Qf, cfg, sc.sat, sc.du),
        "mpc_embedded": lambda: port.mpc(prob.x0, model_e, prob.plant, prob.X_targ, sc.U_targ,
                                         prob.Q, sc.R, prob.Qf, cfg, sc.sat, sc.du),
        "batched_complex": lambda: port.batched_mpc(sc.x0, sc.model, lanes, sc.X_targ,
                                                    sc.U_targ, sc.Q, sc.R, sc.Qf, cfg,
                                                    sc.sat, sc.du),
        "batched_embedded": lambda: port.batched_mpc(
            prob.x0, model_e, embedded.EmbeddedPlant(lanes), prob.X_targ, sc.U_targ, prob.Q,
            sc.R, prob.Qf, cfg, sc.sat, sc.du)}
    rec = {"phase": "embedded", "gpu": smi_line(), "B": B, "gates": {"du": EMBEDDED["du_tol"]}}
    out = {}
    for name, fn in runs.items():
        t0 = time.perf_counter()
        out[name], launches, reads = counted(counters, host_flag, fn)
        res = out[name]
        rec[name] = {"wall_s": time.perf_counter() - t0, "launches": launches,
                     "host_reads": reads, "sqp_iters": batch_iters(res),
                     "exit_codes": sorted(set(res.exit_code.reshape(-1).tolist()))}
    # float32's own reach on this batch: the complex run against float64
    sc64 = presets.not_state(device="cpu", dtype=torch.float64)
    ref64 = port.batched_mpc(sc64.x0, sc64.model, make_lanes(sc64.plant, B), sc64.X_targ,
                             sc64.U_targ, sc64.Q, sc64.R, sc64.Qf,
                             dataclasses.replace(sc64.config, qp_backend="ns"), sc64.sat,
                             sc64.du)
    rec["batched_complex_vs_f64_max_abs_du"] = float(
        (out["batched_complex"].us.cpu().double() - ref64.us).abs().max())
    for kind in ("mpc", "batched"):
        c, e = out[f"{kind}_complex"], out[f"{kind}_embedded"]
        rec[f"{kind}_max_abs_du"] = float((c.us - e.us).abs().max())
        rec[f"{kind}_median_abs_du"] = float((c.us - e.us).abs().median())
        rec[f"{kind}_max_abs_dx_final"] = float(
            (embedded.unembed_vec(e.xs[..., -1]) - c.xs[..., -1]).abs().max())
    rec["mpc_p1"] = float(out["mpc_embedded"].xs[3, -1])
    emit(rec)
    for kind in ("mpc", "batched"):
        require(rec[f"{kind}_max_abs_du"] <= EMBEDDED["du_tol"][kind], f"embedded {kind}: {rec}")
        for form in ("complex", "embedded"):
            r = rec[f"{kind}_{form}"]
            require(r["exit_codes"] == [0] and r["launches"] == {
                "boxqp_small": r["sqp_iters"], "expm_small": 20, "admm_big": 0,
                "condense_small": r["sqp_iters"] if form == "complex" else 0, "ns_cold": 0},
                    f"embedded {kind}_{form}: launches or exit codes {r}")
    return rec


def free_port() -> int:
    """A free TCP port on localhost, for the process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class CollectiveClock:
    """While installed, counts the torch.distributed collectives the port
    calls (all_gather_into_tensor, all_reduce) and times each by CUDA events
    around the call (a collective that returns has finished on the current
    stream). The port's code is left as it is: the functions are wrapped on
    the torch.distributed module and restored on exit."""

    NAMES = ("all_gather_into_tensor", "all_reduce")

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.events = dist, {n: [] for n in self.NAMES}
        self.saved = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def wrapped(*a, _fn=fn, _name=name, **k):
                start, stop = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                start.record()
                out = _fn(*a, **k)
                stop.record()
                self.events[_name].append((start, stop))
                return out
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)

    def report(self) -> dict:
        """Per collective: calls, their summed ms, and the first and median
        call's ms."""
        torch.cuda.synchronize()
        out = {}
        for name, ev in self.events.items():
            ms = [a.elapsed_time(b) for a, b in ev]
            out[name] = {"calls": len(ms), "ms": sum(ms), "first_ms": ms[0] if ms else None,
                         "median_ms": float(np.median(ms)) if ms else None}
        return out


def fidelity(xs, targ) -> torch.Tensor:
    """Per-lane Re <targ, x_final> of a batch's (B, dim_e, n + 1) record."""
    return (xs[..., -1] @ targ.conj()).real


def phase_tp_3q(port, counters, host_flag, tensor) -> dict:
    """The 3-qubit dim_x 64 problem at B 1024 (TP3Q) through batched_mpc on
    the kernel route, dense and with tp_model_fns on a one-rank "op" axis of
    the NCCL group, with each run's launches, host reads, collectives and
    wall time (after a warm-up run of each); 8 lanes again in float64 on
    the CPU."""
    from mpc4quantum_tpu_torch.ops.expm import taylor_budget
    from mpc4quantum_tpu_torch.presets import three_qubit_problem

    B, lanes = TP3Q["batch"], TP3Q["parity_lanes"]
    args, targ = three_qubit_problem(DEVICE, torch.float32)
    nominal64, targ64 = three_qubit_problem("cpu", torch.float64)
    plants64 = make_lanes(nominal64["plant"], B)
    plants = plants64.to(DEVICE, torch.float32)
    cfg = dataclasses.replace(args["config"], qp_backend="ns")
    budget = taylor_budget(plants.norm_bound(cfg.dt, args["sat"]))
    require(budget == TP3Q["expm_budget"], f"tp_3q expm budget {budget}")
    run_args = lambda a, p: (a["x0"], a["model_state"], p, a["X_targ"], a["U_targ"], a["Q"],
                             a["R"], a["Qf"], cfg, a["sat"], a["du"])
    mesh = tensor.op_mesh(n_op=1)
    fns = tensor.tp_model_fns(mesh, dim_u=3, order=1, dim_x=64)
    rec = {"phase": "tp_3q", "gpu": smi_line(), "B": B, "dim_x": 64, "qp_n": 24,
           "expm_d": 8, "expm_budget": list(budget), "op_ranks": 1,
           "backend": torch.distributed.get_backend(), "gates": TP3Q}
    out = {}
    for name, kw in (("dense", {}), ("tp", {"model_fns": fns})):
        # a warm-up run first: the TP run's first gather sets up the NCCL
        # communicator
        port.batched_mpc(*run_args(args, plants), **kw)
        with CollectiveClock() as clock:
            t0 = time.perf_counter()
            res, launches, reads = counted(counters, host_flag, lambda: port.batched_mpc(
                *run_args(args, plants), **kw))
            wall = time.perf_counter() - t0
        fid = fidelity(res.xs, targ)
        codes = res.exit_code
        iters = batch_iters(res)
        out[name] = res
        rec[name] = {"wall_s": wall, "launches": launches, "host_reads": reads,
                     "collectives": clock.report(), "sqp_iters": iters,
                     "sqp_iters_by_step": res.sqp_iters.amax(dim=0).tolist(),
                     "fidelity_mean": float(fid.mean()), "fidelity_min": float(fid.min()),
                     "completed_frac": float(((codes == 0) | (codes == 1)).float().mean()),
                     "exit_codes": sorted(set(codes.tolist()))}
    d, t = out["dense"], out["tp"]
    rec["tp_vs_dense"] = {"equal": bool(torch.equal(d.us, t.us) and torch.equal(d.xs, t.xs)),
                          "max_abs_dus": float((d.us - t.us).abs().max()),
                          "max_abs_dfid": float((fidelity(d.xs, targ) - fidelity(t.xs, targ))
                                                .abs().max()),
                          "exit_codes_equal": bool(torch.equal(d.exit_code, t.exit_code)),
                          "wall_ratio": rec["tp"]["wall_s"] / rec["dense"]["wall_s"]}
    t0 = time.perf_counter()
    res64 = port.batched_mpc(*run_args(nominal64, plants64[:lanes]))
    dfid = (fidelity(d.xs[:lanes], targ).cpu().double() - fidelity(res64.xs, targ64)).abs()
    rec["lane_parity"] = {"lanes": lanes, "cpu_s": time.perf_counter() - t0,
                          "max_abs_dfid": float(dfid.max()),
                          "max_abs_dus": float((d.us[:lanes].cpu().double() - res64.us)
                                               .abs().max()),
                          "exit_codes_equal": bool(torch.equal(d.exit_code[:lanes].cpu(),
                                                               res64.exit_code)),
                          "fidelity_mean_f64": float(fidelity(res64.xs, targ64).mean())}
    emit(rec)
    for name in ("dense", "tp"):
        r = rec[name]
        # dim_x 64, beyond condense_small's 16: the model phase stays plain;
        # at n 24 every rho round's K^-1 is a cold ns_cold launch
        rounds = cfg.qp_params.n_rounds * r["sqp_iters"]
        expected = {"boxqp_small": 0, "expm_small": cfg.n_steps, "admm_big": rounds,
                    "condense_small": 0, "ns_cold": rounds}
        require(r["launches"] == expected, f"tp_3q {name} launches, expected {expected}: {r}")
        require(r["completed_frac"] == 1.0 and r["fidelity_min"] > TP3Q["fid_min"],
                f"tp_3q {name} gates: {r}")
    gather_calls = rec["tp"]["collectives"]["all_gather_into_tensor"]["calls"]
    require(gather_calls == 3 * rec["tp"]["sqp_iters"] and
            rec["dense"]["collectives"]["all_gather_into_tensor"]["calls"] == 0,
            f"tp_3q: 3 gathers a linearization on the TP run only: {rec}")
    g = rec["tp_vs_dense"]
    require(g["exit_codes_equal"] and g["max_abs_dfid"] <= TP3Q["tp_gap"], f"tp_3q TP: {g}")
    p = rec["lane_parity"]
    require(p["exit_codes_equal"] and p["max_abs_dfid"] <= TP3Q["parity_tol"],
            f"tp_3q lanes differ from the float64 CPU run: {p}")
    return rec


def phase_sharded_fleet(presets, port, counters, host_flag) -> dict:
    """The flagship at B 16384 through sharded_mpc on the one-rank
    "scenarios" mesh of the NCCL group (SHARDED), after a warm-up run,
    against batched_mpc on the same plants; sharded_fleet_summary against
    fleet_summary; scaling_report at one device."""
    B = SHARDED["batch"]
    sc = presets.not_state()
    cfg = dataclasses.replace(sc.config, qp_backend="ns")
    plants = make_lanes(presets.not_state(device="cpu").plant, B).to(DEVICE, torch.float32)
    run = lambda mesh, b: port.sharded_mpc(mesh, sc.x0, sc.model, plants[:b], sc.X_targ,
                                           sc.U_targ, sc.Q, sc.R, sc.Qf, cfg, sc.sat, sc.du)
    mesh = port.scenario_mesh()
    rec = {"phase": "sharded_fleet", "gpu": smi_line(), "B": B, "ranks": mesh.size(),
           "backend": torch.distributed.get_backend(), "gates": SHARDED}
    # a warm-up: the first gather and each all_reduce's first call of its
    # dtype and op load their NCCL code
    port.sharded_fleet_summary(mesh, run(mesh, B), sc.target_state)
    with CollectiveClock() as clock:
        t0 = time.perf_counter()
        res, launches, reads = counted(counters, host_flag, lambda: run(mesh, B))
        wall = time.perf_counter() - t0
        summary = port.sharded_fleet_summary(mesh, res, sc.target_state)
        collectives = clock.report()
    t0 = time.perf_counter()
    ref, ref_launches, _ = counted(counters, host_flag, lambda: port.batched_mpc(
        sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, cfg, sc.sat, sc.du))
    ref_wall = time.perf_counter() - t0
    plain = port.fleet_summary(ref, sc.target_state)
    fid = fidelity(res.xs, sc.target_state)
    codes = res.exit_code
    rows = port.scaling_report(run, batch_per_device=B, device_counts=(1,), reps=1)
    rec.update({
        "wall_s": wall, "batched_wall_s": ref_wall, "rollouts_per_s": B / wall,
        "launches": launches, "batched_launches": ref_launches, "host_reads": reads,
        "sqp_iters": batch_iters(res), "collectives": collectives,
        "fidelity_mean": float(fid.mean()), "fidelity_min": float(fid.min()),
        "completed_frac": float(((codes == 0) | (codes == 1)).float().mean()),
        "qp_fail_frac": float((codes == 2).float().mean()),
        "vs_batched": {"equal": all(torch.equal(getattr(res, f), getattr(ref, f))
                                    for f in ("xs", "us", "exit_code", "n_valid", "sqp_iters")),
                       "max_abs_dus": float((res.us - ref.us).abs().max()),
                       "max_abs_dxs": float((res.xs - ref.xs).abs().max())},
        "summary": {k: float(v) for k, v in summary.items()},
        "summary_gap": max(abs(float(summary[k]) - float(plain[k])) for k in plain),
        "scaling_report": rows})
    emit(rec)
    v = rec["vs_batched"]
    require(v["max_abs_dus"] <= SHARDED["equal_tol"] and v["max_abs_dxs"] <= SHARDED["equal_tol"]
            and torch.equal(res.exit_code, ref.exit_code), f"sharded_fleet vs batched_mpc: {v}")
    require(rec["summary_gap"] <= SHARDED["equal_tol"], f"sharded_fleet summary: {rec}")
    expected = {"boxqp_small": rec["sqp_iters"], "expm_small": cfg.n_steps, "admm_big": 0,
                "condense_small": rec["sqp_iters"], "ns_cold": 0}
    require(launches == expected == ref_launches, f"sharded_fleet launches, expected {expected}")
    require(collectives["all_gather_into_tensor"]["calls"] == 6
            and collectives["all_reduce"]["calls"] == 4,
            f"sharded_fleet: 6 gathers and 4 all_reduces: {collectives}")
    require(rec["completed_frac"] == 1.0 and rec["qp_fail_frac"] == 0.0
            and rec["fidelity_min"] >= SHARDED["fid_min"], f"sharded_fleet gates: {rec}")
    require(len(rows) == 1 and set(rows[0]) == {"devices", "batch", "best_s",
                                                "per_device_throughput", "efficiency"}
            and rows[0]["efficiency"] == 1.0, f"scaling_report rows {rows}")
    return rec


# graft_entry: graft_entry_torch.entry()'s one MPC step on the card in
# float32 against the same step in float64 on the CPU (on the CPU float32
# is 9.8e-9 from float64; the first control sits on the box edge), and
# dryrun_multichip(1), the sharded tiny rollout on a one-rank NCCL group,
# equal to batched_mpc (the n > 1 ranks run as gloo processes in
# tests/test_torch_graft.py)
GRAFT = dict(state_tol=1e-5, dryrun_gap=1e-6)


def phase_graft_entry(graft, counters) -> dict:
    fn, args = graft.entry()
    fn(*args)
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    x, u = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_launches = {k: fn_.launches for k, fn_ in counters.items()}
    fn64, args64 = graft.entry(device="cpu", dtype=torch.float64)
    x64, u64 = fn64(*args64)
    for k in counters.values():
        k.launches = 0
    dry = graft.dryrun_multichip(1)
    rec = {"phase": "graft_entry", "device": str(x.device), "step_wall_s": wall,
           "step_launches": step_launches,
           "max_abs_dx_vs_f64": float((x.cpu().to(torch.complex128) - x64).abs().max()),
           "abs_du_vs_f64": float((u.cpu().double() - u64).abs().max()),
           "u": float(u[0]), "dryrun": dry,
           "dryrun_launches": {k: fn_.launches for k, fn_ in counters.items()},
           "tolerance": GRAFT}
    emit(rec)
    require(x.device.type == DEVICE and step_launches["expm_small"] == 1
            and step_launches["admm_big"] == 0 and step_launches["boxqp_small"] >= 1
            and step_launches["condense_small"] == step_launches["boxqp_small"],
            f"graft_entry: one step's launches {step_launches}")
    require(rec["max_abs_dx_vs_f64"] <= GRAFT["state_tol"]
            and rec["abs_du_vs_f64"] <= GRAFT["state_tol"],
            f"graft_entry: the card's step differs from float64 on the CPU: {rec}")
    require(dry["world"] == 1 and dry["n_valid"] == 6
            and dry["gap_to_batched"] <= GRAFT["dryrun_gap"], f"graft_entry: dryrun_multichip(1): {dry}")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    if sys.argv[1:2] == ["--time-kernels"]:
        return time_kernels(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else here)
    kernels_only = sys.argv[1:] == ["--kernels"]
    require(kernels_only or not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    sys.path.insert(0, str(here))
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity, run_hostloop_fleet
    from mpc4quantum_tpu_torch.kernels import _build as build
    from mpc4quantum_tpu_torch.kernels._graph import graph_kernel_launches, graph_node_types
    from mpc4quantum_tpu_torch.kernels import admm_big as admm_mod
    from mpc4quantum_tpu_torch.kernels import boxqp as boxqp_mod
    from mpc4quantum_tpu_torch.kernels import condense as condense_mod
    from mpc4quantum_tpu_torch.kernels import expm as expm_mod
    from mpc4quantum_tpu_torch.kernels import nsinv as nsinv_mod
    from mpc4quantum_tpu_torch.solvers.boxqp import (BoxQPParams, accept_thresholds,
                                                     solve_boxqp_fixed)
    from mpc4quantum_tpu_torch.utils.linalg import gj_inverse
    import mpc4quantum_tpu_torch as port
    from mpc4quantum_tpu_torch import systems
    from mpc4quantum_tpu_torch.models import dmdc
    from mpc4quantum_tpu_torch.ops.library import control_powers, lift_controls
    from mpc4quantum_tpu_torch.__main__ import main as cli_main
    from mpc4quantum_tpu_torch.benchfleet import make_runner
    from mpc4quantum_tpu_torch.mpc import fleet_runner
    from mpc4quantum_tpu_torch.solvers.boxqp import solve_boxqp
    from mpc4quantum_tpu_torch.utils.profiling import host_flag
    from mpc4quantum_tpu_torch.parallel import tensor

    torch_mods = {"presets": presets, "control_powers": control_powers,
                  "lift_controls": lift_controls,
                  **{k: getattr(port, k) for k in ("MPCConfig", "QuantumPlant", "quantum_simulate",
                                                   "quantum_observe", "train_model",
                                                   "dmdc_from_operator", "mpc")}}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_toolchain(build)
    phase_build(build)
    phase_plans(build, expm_mod, admm_mod)
    floor_us = launch_floor_us()
    qp = {} if kernels_only else {
        shape: phase_boxqp(boxqp_mod, accept_thresholds, graph_node_types, shape, floor_us)
        for shape in QP_FORMS}
    ex = phase_expm(expm_mod, graph_node_types, floor_us, build, graph_kernel_launches)
    ad = phase_admm(admm_mod, gj_inverse, build, graph_kernel_launches)
    phase_speed(ex, ad)
    cond = phase_condense(condense_mod, graph_node_types, floor_us)
    nsinv = phase_nsinv(nsinv_mod, graph_node_types, floor_us)
    if kernels_only:
        print(smi_line(), flush=True)
        emit({"ok": True, "kernels_only": True})
        return 0
    phase_boxqp_big(boxqp_mod, BoxQPParams, solve_boxqp_fixed, accept_thresholds)
    counters = {"boxqp_small": boxqp_mod.boxqp_small, "expm_small": expm_mod.expm_small,
                "admm_big": admm_mod.admm_big, "condense_small": condense_mod.condense_small,
                "ns_cold": nsinv_mod.ns_cold}
    total, flagship, defaults = dict.fromkeys(counters, 0), None, {}
    add = lambda launches: {k: total[k] + launches.get(k, 0) for k in total}
    for name in FLEETS:
        sc, plants64, out, launches, metrics = phase_fleet(name, presets, run_hostloop_fleet,
                                                           counters)
        flagship = metrics if name == "not_state" else flagship
        total = add(launches)
        _, fid64, codes64 = phase_parity(name, presets, run_hostloop_fleet, fleet_fidelity,
                                         sc, plants64, out)
        defaults[name] = {"metrics": metrics, "fid64": fid64, "codes64": codes64,
                          "fid": fleet_fidelity(sc, out["final_x"])}
    import bench_torch
    total = add(phase_bench_entry(bench_torch, presets, make_runner, counters,
                                  flagship)["launches"])
    phase_kinv_builds(presets, fleet_runner, run_hostloop_fleet)
    for kind in ("riccati", "warm_kinv"):
        total = add(phase_kinv_fleet(kind, presets, run_hostloop_fleet, fleet_fidelity,
                                     counters, defaults)["launches"])
    total = add(phase_classical(port, counters, host_flag)["launches_total"])
    rec = phase_embedded(presets, port, counters, host_flag)
    for name in ("mpc_complex", "mpc_embedded", "batched_complex", "batched_embedded"):
        total = add(rec[name]["launches"])
    phase_rescue(presets, run_hostloop_fleet, fleet_fidelity, counters)
    for name, make in (("damped_pair", presets.damped_pair_scenario),
                       ("cnot_h80", presets.cnot_h80_scenario),
                       ("damped_chain4", presets.damped_chain4_scenario),
                       ("cnot_h250", presets.cnot_h250_scenario)):
        rec = phase_slice_fleet(name, make, make_runner, run_hostloop_fleet, fleet_fidelity,
                                counters)
        total = add(rec["launches"])
        total = add(rec["parity"]["launches"])
    for kind in ("online", "discrep"):
        rec = phase_learned_fleet(kind, presets, dmdc, run_hostloop_fleet, fleet_fidelity,
                                  counters, flagship)
        total = add(rec["launches"])
    rec = phase_train_then_control(systems, torch_mods, counters, host_flag)
    total = add(rec["card"]["mpc_launches"])
    total = add(rec["card"]["simulate_launches"])
    rec = phase_observe_eops(systems, torch_mods, counters, host_flag)
    total = add(rec["card_chol"]["launches"])
    total = add(rec["card_ns"]["launches"])
    total = add(phase_cli_rollout(cli_main, counters, host_flag)["launches"])
    total = add(phase_cli_lqr(cli_main, presets, port.mpc, counters, host_flag)["launches"])
    total = add(phase_cli_batch(cli_main, presets, port.batched_mpc, fleet_fidelity, counters,
                                host_flag)["launches"])
    rec = phase_fleet_checkpoint(cli_main, presets, fleet_runner, make_runner, counters,
                                 host_flag)
    total = add(rec["launches"])
    total = add(rec["resumed_launches"])
    phase_chol_qp(solve_boxqp, BoxQPParams, boxqp_mod, host_flag)
    # the multi-device layer on a real NCCL group of one rank (one card)
    port.init_distributed(f"tcp://localhost:{free_port()}", 1, 0)
    try:
        rec = phase_tp_3q(port, counters, host_flag, tensor)
        total = add(rec["dense"]["launches"])
        total = add(rec["tp"]["launches"])
        rec = phase_sharded_fleet(presets, port, counters, host_flag)
        total = add(rec["launches"])
    finally:
        torch.distributed.destroy_process_group()
    import graft_entry_torch
    rec = phase_graft_entry(graft_entry_torch, counters)
    total = add(rec["step_launches"])
    total = add(rec["dryrun_launches"])

    gpu = smi_line()
    print(gpu, flush=True)
    # each kernel's runs over all its checked shapes; the first is the one
    # the line reports (the flagship's cold QP and expm, drag's
    # 50-iteration ADMM), every shape is in the phase lines above
    qp_runs = [qp[shape][f] for shape, forms in QP_FORMS.items() for f in forms]
    ex_runs = [ex[f] for f in EXPM_CASES]
    ad_runs = [ad[f"B{B}_n{n}_it{it}"] for B, n, it in ADMM_SHAPES]
    cond_runs = [cond[f"{name}_b{B}"] for name, B in CONDENSE_SHAPES]
    ns_runs = [nsinv[f"B{B}_n{n}_it{it}"] for B, n, it in NSINV_TIMED]
    kernels = (("boxqp_small", "mpc4quantum_tpu/ops/pallas_qp.py:42", qp_runs,
                max(max(r["max_dz"], r["max_dy"]) for r in qp_runs)),
               ("expm_small", "mpc4quantum_tpu/ops/pallas_expm.py:64", ex_runs,
                max(r["max_abs_err"] for r in ex_runs)),
               ("admm_big", "mpc4quantum_tpu/ops/pallas_qp.py:345", ad_runs,
                max(r["max_abs_err"] for r in ad_runs)),
               ("condense_small", "none (XLA's contractions of model_along_traj and qp_data)",
                cond_runs, max(r["max_rel_err"] for r in cond_runs)),
               ("ns_cold", "none (XLA's matmuls of ns_inverse's cold chain)", ns_runs,
                max(nsinv[f"B{B}_n{n}_it{it}"]["max_rel_err"] for B, n, it in NSINV_SHAPES)))
    emit({"gpu": gpu, "kernels": [
        {"name": name, "route": "cuda", "source": f"mpc4quantum_tpu_torch/csrc/{name}.cu",
         "replaces": replaces, "launches": total[name], "max_abs_err": err,
         "ms": rep["kernel_ms"], "device_ms": rep["device_us"] / 1e3, "plain_ms": rep["plain_ms"],
         "bound_ms": rep["bound_us"] / 1e3, "bound_us": rep["bound_us"],
         "bound_by": rep["bound_by"], "library_ms": rep.get("library_ms"),
         "launch_floor_us": floor_us}
        for name, replaces, (rep, *_), err in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
