#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is then not
printed):
1. The card's name and power limit, torch and CUDA versions.
2. Build the fused ADMM segment kernels from ``porqua_tpu_torch/csrc``
   (the three sources at once, one nvcc each) and print ptxas'
   registers, shared memory and spills of the cluster kernels.
3. Each kernel form against its plain PyTorch twin on the card, on the
   first segment's operator and state of the port's own pipeline for
   the 252-date x 500-asset f32 batch (seed 42): errors, kernel and
   plain times (CUDA events, median of 10 after warm-up) and the
   roofline bound of the same work. Every segment has two kernels, a
   cluster form (the factored one on 8 blocks, L^-1 on 8, K^-1 on 16)
   and the streaming form; both run on the same inputs, timed in turns
   (stream, cluster, cluster, stream), beside the device-memory bytes
   each design moves, the shared memory and resident clusters of the
   cluster form, and the time of a launch with one iteration. Then
   every form, the factored device-memory one included, at the ragged
   widths (``ragged_twin_checks``), and the forms that serve the shapes
   the cluster forms do not fit (``GAP_SHAPES``: the service's 1,024 x
   128 and 512 x 512 rungs through the dense streaming form, 2,048 x 8
   and the 5,000-asset sketch shape through the factored device-memory
   form), each a kernel row.
4. The main path: ``tracking_step`` on that batch with
   ``backend="pallas"`` for every config of the JAX golden
   (``porqua_tpu_torch/testdata/tracking_golden.npz``), with the launch
   counters set to 0 before each run and read after it (every config
   must go through its cluster form and never the streaming one);
   status and iterations must equal the golden on every date,
   weights within |dw| <= 1e-4 and the median tracking error within
   1e-4 relative.
   The same solves on the plain path (``backend="xla"``) are timed
   beside it, and one headline run is profiled (device time by kernel).
5. The backtest: ``run_batch`` on ``examples/backtest_usa.py``'s
   configuration 1 at full scale (520 assets, 1,500 days, 55 monthly
   rebalances, a 252-day window, LeastSquares with budget and box
   <= 0.05, f32, polish on) for two solver configs, ``usa_trinv`` (the
   triangular-inverse kernel) and ``usa_woodbury`` (the factored kernel
   at refine 1), against the JAX golden
   (``porqua_tpu_torch/testdata/backtest_usa_golden.npz``): host build,
   host-to-device copy, solve, polish and accounting times, launches
   per form, and the checks listed at ``backtest_phase``. Each config's
   segment kernel is also held against its plain twin at this shape.
6. The date-chained backtests, against the JAX golden
   (``porqua_tpu_torch/testdata/scan_golden.npz``; checks listed at
   ``scan_phases`` and ``turnover_phase``): ``solve_scan_l1`` over 64
   dates of the 500-asset universe (the factored kernel in its cluster
   form at one problem per launch, the L1 cost on, each date
   warm-started from the last), ``solve_scan_l1_grid`` over 8 benchmark
   columns (the triangular-inverse kernel at 8 problems per launch),
   the checkpointed runners killed by an injected crash and resumed
   (bit-identical to an uninterrupted run), and ``solve_scan_turnover``
   on ``examples/backtest_usa.py``'s configuration 2 (f64, the plain
   path, no kernel). Each date is held from the golden's carry, and the
   grid's chain by a twin rule against the f64 chain; controls with a
   faulty carry must fail the checks. Each chain's kernel call on its
   third date is held against its plain twin and timed; one
   ``solve_scan_l1`` run is profiled.
7. Serving: the reference loadgen's north-star stream (512 tracking
   requests of 500 assets, bucket 512 x 8) through ``SolveService`` on
   the card (max_batch 256, the whole slot ladder prewarmed) in three
   runs, ``serve_trinv`` and ``serve_woodbury`` (the micro-batcher;
   the triangular-inverse and the factored kernel) and
   ``serve_continuous`` (the continuous batcher, one segment per
   launch), each a burst of 512 then ``run_loadgen``'s closed loop at
   24 in flight, against the JAX golden
   (``porqua_tpu_torch/testdata/serve_golden.npz``; checks listed at
   ``serve_phase``), with one profiled burst; each micro-batcher run's
   kernel is held against its plain twin on its first full batch.
8. The secondary configurations of bench.py, against the JAX golden
   (``porqua_tpu_torch/testdata/secondary_golden.npz``; checks listed at
   ``secondary_phase``): segment compaction (``CompactingDriver``, the
   width walking down the slot ladder) on the headline batch at eps
   1e-5 for the factored kernel, the triangular-inverse kernel and
   NAPG, each against the fused solve; the PDHG and NAPG backends
   beside ADMM; the 5,000-asset north star through the count-sketch on
   all three backends, with the golden's draws and with the port's own;
   the sketch's passthrough at 2,048 assets; the north star's two
   woodbury arms again with ``backend="pallas"`` (the factored
   device-memory form at B = 1); ``solve_qp_batch`` on 8 problems of
   1,000 assets and 101 rows at the (1024, 128) rung through the dense
   streaming form (trinv and inverse) against the plain path; one
   profiled compacted solve. Each kernel is held against its plain twin
   at a narrow rung.
9. The differentiable solve, against the JAX golden
   (``porqua_tpu_torch/testdata/diff_golden.npz``; rules at
   ``DIFF_PATH``, checks listed at ``diff_phase``): gradients of
   examples/differentiable_tuning.py's out-of-sample TE w.r.t. the ridge
   and the benchmark through ``solve_qp_batch_diff`` on the headline
   batch (the triangular-inverse kernel, the factored kernel at refine
   1, and the dense adjoint), examples/net_sharpe_tuning.py's chain of
   ``solve_qp_l1_diff`` solves (the factored kernel at B = 1) through
   ``accounting.simulate``, the box-bound cotangents with two faulty
   backwards as controls, and ``compare_solvers`` (device rows on the
   card, the f64 IPM, the native C++ core built here, SLSQP) with the
   f32 row through the triangular-inverse kernel.
10. The routed, retried and observed service (``routed_serve_phase``):
   phase 7's stream through a ``SolverRouter`` with retries, spans,
   harvest, SLOs, flight recorder and anomaly detection, the
   three-tenant blend, the calibration and chaos cells.
11. The device-cost plane (``cost_phase``): phase 7's stream through
   the triangular-inverse and the factored kernel with CostRecords of
   every built entry (their flops, bytes, peak memory and kernel part
   held against the launches), a per-dispatch roofline on every
   harvest record, a bounded profiler window over the burst, the
   roofline verdict, the text report, the run ledger and a fleet of
   two services on the card.
12. The ML selection models (``ml_phase``), against the JAX golden
   (``porqua_tpu_torch/testdata/ml_golden.npz``; checks listed at
   ``ml_phase``): the pairwise LTR ranker trained on the card for the
   first 12 rebalance dates of the USA example at full width, its
   selection (top 260 of 520) feeding ``run_batch`` for ``usa_trinv``
   (the triangular-inverse kernel) and ``usa_woodbury`` (the factored
   kernel at refine 1); the shipped LSTM ranker, ``train_lstm`` from
   the golden's draws, the reference's Keras architecture, the ordinal
   regressions and OLS/PCA/PCAOLS on the USA monthly panel.
13. The mesh, the process group and the transfer guard
   (``mesh_phase``; checks listed there): the tracking batch through
   ``solve_qp_sharded`` (K1 and K2) and phase 6's grid through
   ``solve_scan_l1_grid(mesh=)``, bit-equal to the unsharded runs; a
   one-process NCCL group and its (1, 1) multihost mesh;
   ``solve_batch``, a compacted solve and a serving burst under
   ``PORQUA_SANITIZE=1``, bit-equal to the unguarded runs, each with a
   seeded control that the guard must catch; the op-trace contracts and
   the op-trace harvest on the card.
14. The examples (``examples_phase``): every example of
   ``porqua_tpu_torch/examples/`` (the twins of ``examples/*.py``)
   through its ``main`` at the JAX examples' own sizes, against the JAX
   goldens (``porqua_tpu_torch/testdata/examples_golden.npz``; rules at
   ``EXAMPLES_PATH``), each with its time and the kernels' launch
   counts (backend "auto": none). Phase 3 also holds every kernel form,
   the streaming ones included, at the ragged widths of the gpu tests
   (``ragged_twin_checks``).
15. One JSON line per kernel, then the card line, then the result line.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# Kernel vs its plain twin. Both run f32 arithmetic in different
# summation orders for 25-35 ADMM iterations, and an iterate near a
# clip or prox kink can amplify a last-bit difference, so neither is
# "the" answer. Both are held against the plain version run in float64
# on the same inputs: per output, the kernel's distance to it may be at
# most KERNEL_VS_PLAIN times the f32 rounding noise of the function,
# plus ULPS_PER_ITER f32 ulps of the output's scale (the state vector
# it belongs to) for every iteration of the segment. The noise is the
# largest distance to float64 of the f32 twin over TWIN_ORDERS, four
# summation orders of the same arithmetic on the same inputs: the batch
# on the card, the batch on the CPU, the batch with its lanes reversed,
# and lane by lane at B = 1 (every lane up to TWIN_LANES lanes, else
# TWIN_LANES of them evenly spaced). One f32 run alone is a draw: on the
# small duals (y, dy, mu, dmu) the twin's run on the card lands up to
# 2,700x nearer float64 than its run on the CPU
# (scripts/torch_twin_margins.py). This one rule holds every kernel
# form here and in the gpu tests (tests/test_torch_cuda.py).
KERNEL_VS_PLAIN = 4.0
ULPS_PER_ITER = 2
TWIN_ORDERS = ("card", "cpu", "reversed", "lanes")
TWIN_LANES = 16
F32_EPS = 2.0 ** -23
OUT_NAMES = ("x", "z", "w", "y", "mu", "dx", "dy", "dmu")
SCALE_OF = (0, 1, 2, 3, 4, 0, 3, 4)
# Card vs JAX golden (XLA-CPU, f32): equal status and iterations on
# every date, weights within W_ATOL and the median tracking error
# within TE_RTOL. The JAX package's own f32 batched-vs-serial figure is
# |dw| <= 1e-3; the card measured |dw| <= 4.3e-5 (explicit inverse;
# 2.5e-5 in the other configs) and TE within 2.1e-5 (H100 SXM, 700 W),
# so the bounds sit at 2.3x and 4.8x that.
W_ATOL = 1e-4
TE_RTOL = 1e-4
# The backtest's weights are held by the same twin rule as the kernels,
# one level up. Its benchmark is a portfolio of its own universe and the
# window (252 days) is shorter than the universe (520 assets), so every
# date's optimum is a face of exact replication, not a point: the f32
# weights there are fixed only up to rounding, and XLA-CPU's f32 answer
# sits up to 1.2e-4 from its own f64 twin (the golden's weights_f64
# arrays). Per date, the card's ADMM iterate may be at most
# KERNEL_VS_PLAIN times as far from the f64 iterate as XLA-CPU's f32
# iterate is, plus ULPS_PER_ITER f32 ulps of the largest weight per
# iteration; its in-sample tracking error (the objective, unique on the
# face) at most KERNEL_VS_PLAIN times XLA-CPU's.
BT_PATH = os.path.join("porqua_tpu_torch", "testdata",
                       "backtest_usa_golden.npz")
# The date-chained backtests (scan phases) hold the card against the
# JAX package on XLA-CPU. The L1 chain and its grid: each date solved
# alone from the golden's carry by W_ATOL/TE_RTOL above, with equal status
# and iterations; the chain as the entry point runs it by status on every
# date. Its weights drift from chain to chain: each date's optimum is a
# face, so a last-bit difference that moves one date's stopping point
# stays in every later date's L1 center (ROADMAP section C). The grid's
# chain is held by the chain twin rule: per lane, the card's largest
# distance over the dates to the f64 chain at most CHAIN_VS_TWIN times
# the largest of three f32 twins' (XLA-CPU's chain, the plain path on
# the card and on the CPU). Healthy f32 chains of one algorithm differ
# in that distance by up to 10.9x (the card's plain path against the
# kernel's and the CPU's on lane 0 at seed 7, H100 SXM 700 W; 11.2x
# between XLA-CPU and the port on the CPU at a small size,
# scripts/torch_scan_drift.py and tests/test_torch_scan.py), so the rule
# takes 16, not KERNEL_VS_PLAIN; a chain whose holdings never advance
# sits 1,140x off on the card. The single chain's rule is printed, not
# held: there even two f64 chains (the card's plain path, XLA-CPU) end
# 1.7e-2 apart, and the chain whose holdings never advance is no
# farther from the f64 chain than a sound one.
SCAN_PATH = os.path.join("porqua_tpu_torch", "testdata", "scan_golden.npz")
CHAIN_VS_TWIN = 16.0
USA_WIDTH, USA_UPPER, USA_BUDGET = 252, 0.05, 0.25
# examples/backtest_usa.py configuration 2 (f64, eps 1e-8, the plain
# path) by status on every date, |dw| <= USA_W_ATOL and its turnover
# budget to 1e-6. Its weights are fixed only to about the residual over
# the ridge's modulus (1e-8 / 2e-4). The limit sits between the sound
# readings (the card 7.4e-5; the port on the CPU, f64 as XLA-CPU,
# 2.0e-4 over the chain, ROADMAP section C) and the controls over the
# first USA_CONTROL_DATES dates (holdings never advanced: 1.05e-3 to
# 1.73e-3 on dates 1-5 on the card; rows written one row early: no date
# solved), and is the bound the example's own serial and scan engines
# are held to (tests/test_backtest_usa.py).
USA_W_ATOL = 5e-4
USA_CONTROL_DATES = 6
# The serving phase holds every request of the north-star stream by the
# tracking limits above (the same per-date QP at ridge 0, bucket-padded
# to 512 x 8) against the JAX golden: status and iterations equal,
# |dx| <= W_ATOL over the 500 real entries, budget and box to eps_abs.
SERVE_PATH = os.path.join("porqua_tpu_torch", "testdata", "serve_golden.npz")
# Phase 8 holds bench.py's secondary configurations against the JAX
# golden (XLA-CPU; tests/test_torch_compaction.py --write-golden). Each
# tracking window (252 days) is shorter than its universe (500 assets),
# so the optimum is a face: the in-sample TE (the objective) is unique,
# the weights are not, and at eps 1e-5 an f32 run can stop anywhere
# within eps of the face (XLA-CPU's own NAPG dates sit up to 3.2e-3 from
# its f64 run's). So per date the TE band: |TE - TE_f64| at most
# KERNEL_VS_PLAIN times the largest such distance of any of XLA-CPU's
# f32 dates (the config's f32 floor at this eps), plus ULPS_PER_ITER f32
# ulps of the TE per iteration; a control with the dates out of order
# must fail it. Where every golden date lies within W_ATOL of the f64
# answer (compact_trinv), also |dw| <= W_ATOL on the dates that stop at
# the golden's check; elsewhere |dw| is printed. Median TE within
# TE_RTOL of the golden's, or, where the golden's own median sits
# farther from the f64 run's, within KERNEL_VS_PLAIN times that. The
# compacted solve (ON) against the fused one (OFF): the dates stepped
# only at widths of 128 or more, the first-boundary ones among them,
# bit for bit (on the card a batched product below 128 problems may
# take another summation order, ROADMAP section C); every date by the
# TE band; median TE within TE_DRIFT (the reference's acceptance).
SECONDARY_PATH = os.path.join("porqua_tpu_torch", "testdata",
                              "secondary_golden.npz")
# Phase 10 holds the routed, retried and observed service against
# serve_golden.npz by phase 7's rule and against the route golden
# (XLA-CPU; tests/test_torch_routing.py --write-golden): the north-star
# stream's answers on PDHG and NAPG, the aggregate that seeds the route
# table, and the blend's pools on their routed backends. SHADOW_BUDGET:
# shadow re-solves per classic run (each re-solves one dispatched batch
# on a losing backend). A shadow lane's status must equal the golden's
# on its loser and its iterations too, or differ by one check interval
# on at most SHADOW_OFF_SHARE of the lanes (a residual check on the
# other side of eps in f32; SHADOW rule, chip_smoke.shadow_rule); each
# lane held against the other loser's golden answer must fail it. The
# blend: status equal, iterations within one check interval and |dx| <=
# W_ATOL (phase 7's rule) against the golden's answer to the same pool
# problem; the next pool problem's answer must fail it. CHAOS_ATOL is
# the chaos suite's wrong-answer bar (scripts/chaos_suite.py).
ROUTE_PATH = os.path.join("porqua_tpu_torch", "testdata", "route_golden.npz")
SHADOW_BUDGET = 1
SHADOW_OFF_SHARE = 0.1
STREAM_MAX_BATCH = 256
BLEND_MAX_BATCH = 16
CHAOS_ATOL = 5e-4
POISON_SHADOW_RATE = 0.125
ON_OFF_WIDTH = 128
# Phase 10's routers run with the device-cost plane off. The plane
# counts every aten op of each entry's warm-up through a
# TorchDispatchMode, and NAPG's ladder runs its row-by-row projection
# there (thousands of small ops per entry), so counting makes the
# routers' prewarm several times longer. Phase 10 tests routing, not
# cost; phase 11 runs the plane on phase 7's stream, and prints the
# prewarm with the plane on and off.
ROUTER_COST_LOG = False
# Phase 11 (the device-cost plane): the services' batching wait, long
# enough that a burst of 512 forms two full batches of 256 (so the
# plane-on and plane-off services dispatch the same batches and must
# serve the same bits), and the profiler window over the burst.
COST_MAX_WAIT_MS = 2000.0
COST_WINDOW_S = 4.0
TE_DRIFT = 1e-6
# The backends' A/B: each alternate backend's median TE within
# BACKEND_BAND of the ADMM arm's (bench_gate's config_pdhg/config_napg
# band). PDHG stops at max_iter on every date (as on XLA-CPU), so its
# iterate is held by its median TE against the golden's within
# PDHG_TE_RTOL: the port on the CPU lands 1.1e-4 from it over 12 dates
# (its f32 iterate after 8,000 steps; per date up to 6.3e-4; the H100
# over all 252: 1.3e-6), the bound sits at 5x the CPU's, and the ADMM
# arm's median TE, a different iterate of the same problems, lies
# 9.9e-3 away (the control).
BACKEND_BAND = 0.02
PDHG_TE_RTOL = 5e-4
# Phase 9 holds the differentiable solve against the JAX golden
# (XLA-CPU; tests/test_torch_diff.py --write-golden), each run in f32
# and in f64. Forward: status and iterations equal on every date. The
# active sets (aC, aB and the two side indicators, qp.diff.active_sets)
# equal the golden's on at least as many dates as XLA-CPU's own f32
# sets equal its f64 ones (a coordinate within eps of its bound may
# classify either way in f32). Gradients by the twin rule, per date on
# the dates whose sets and status equal the golden's and for the
# aggregate: the card's distance to the f64 run at most KERNEL_VS_PLAIN
# times XLA-CPU f32's, plus GRAD_ULPS f32 ulps of the value; a date that
# is not SOLVED has zero gradient on both sides. A date's dL/dtheta is
# one number, and XLA-CPU's f32 distance to f64 there spans five decades
# over the dates (3e-13 to 3.8e-8 in diff_trinv): the port's own f32 run
# on the CPU, a second healthy implementation, lands up to 22.7 times
# past that date's band on 11 of 247 dates. So per date dL/dtheta is
# held to the configuration's f32 floor (XLA-CPU's largest distance over
# the held dates, as phase 8's TE band), dL/dy_fit (252 numbers a date)
# to each date's own. A configuration at its f32 floor (diff_woodbury:
# f32 Woodbury at eps 1e-5, where XLA-CPU stops at its f64 run's check
# on 24/252 dates) holds its status as SOLVED or MAX_ITER, and its
# gradients, dL/dy_fit too, to the floor band on the dates that stopped
# at the golden's check. Where XLA-CPU's f32 gradient is not finite
# (diff_dense: its f32 dense adjoint is NaN on every date, ROADMAP
# section C) there is no twin, and the dense run is held by its forward,
# its sets and finite gradients only. The box problem's field gradients
# (one problem; the budget row's l cotangent is one number) are held to
# the problem's f32 floor: KERNEL_VS_PLAIN times XLA-CPU's largest
# relative distance over the fields, times each field's scale (the H100
# landed 1.6x past l's own band, 0.19 of the floor's). The chain (each
# date's solution the next date's L1 center): per date from the golden's
# carry with the golden's incoming cotangent, by the same rule on the
# dates whose vjp classification (qp.diff.l1_active_sets) equals the
# golden's, at least as many as XLA-CPU's f32-to-f64; its whole
# dS/dlog(lambda) is printed beside the golden's, not held (an f32 chain
# of faces drifts, ROADMAP section C). The cross-solver table: every
# expected row present with no error, found where the golden's is; each
# found row's objective within COMPARE_OBJ of ipm-f64's and the ipm,
# native and SLSQP rows' objective and residual columns within
# COMPARE_HOST of the golden's, both relative to max(1, |value|) (the
# JAX package's own MSCI comparison, tests/test_compare.py: the
# tracking objective, a sum of squared residuals, is ~1e-4, and an
# eps-1e-8 ADMM row sits ~1e-10 from the IPM optimum).
DIFF_PATH = os.path.join("porqua_tpu_torch", "testdata", "diff_golden.npz")
GRAD_ULPS = 2
COMPARE_OBJ = 1e-6
COMPARE_HOST = 1e-9
FAILURES = []


def check(ok, msg):
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        FAILURES.append(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup, reps):
    """Median of ``reps`` single-call times (CUDA events) after warm-up."""
    return statistics.median(cuda_times(fn, warmup, reps))


def cuda_times(fn, warmup, reps):
    """``reps`` single-call times in ms (CUDA events) after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def ptxas_lines(log):
    """ptxas' lines on each kernel's registers, shared memory and
    spills, each group after the line that names its kernel."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


SMALL_FORMS = {
    "factored_refine0": dict(linsolve="woodbury", woodbury_refine=0,
                             check_interval=35, scaling_mode="factored"),
    "factored_refine1": dict(linsolve="woodbury", woodbury_refine=1,
                             check_interval=35, scaling_mode="factored"),
    "triangular": dict(linsolve="trinv"),
    "inverse": dict(linsolve="inverse"),
}


def small_kernel_call(form, dtype, l1=True, n=10, m=1, window=24, batch=3,
                      refine=None):
    """The kernel call of the second segment of a small tracking batch
    in numpy ``dtype``, built by the port's pipeline on the CPU (with a
    native L1 term so the prox's soft-threshold branch runs): ``n``
    assets, a ``window`` of returns (the factored form's k), and
    ``m - 1`` seeded random rows in [-1, 1] beside the budget row.
    ``refine`` overrides the factored forms' refinement rounds."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.qp import admm as tadmm
    from porqua_tpu_torch.qp.solve import _prepare_impl

    opts = dict(SMALL_FORMS[form])
    if refine is not None:
        opts["woodbury_refine"] = refine
    params = pt.SolverParams(eps_abs=1e-12, eps_rel=1e-12, polish=False,
                             scaling_iters=2, backend="pallas", **opts)
    Xs, ys = pt.synthetic_universe_np(11, batch, window, n)
    qp = pt.build_tracking_qp(torch.as_tensor(Xs.astype(dtype)),
                              torch.as_tensor(ys.astype(dtype)))
    if m > 1:
        rows = np.random.default_rng(m).standard_normal((batch, m - 1, n))
        bound = torch.ones((batch, m - 1), dtype=qp.l.dtype)
        qp = qp._replace(
            C=torch.cat([qp.C, torch.as_tensor(rows.astype(dtype))], dim=-2),
            l=torch.cat([qp.l, -bound], dim=-1),
            u=torch.cat([qp.u, bound], dim=-1),
            row_mask=torch.ones((batch, m), dtype=qp.row_mask.dtype))
    scaled, scaling = _prepare_impl(qp, params)[:2]
    l1w = torch.full_like(scaled.q, 1e-3) if l1 else None
    l1c = torch.full_like(scaled.q, 0.1) if l1 else None
    carry = tadmm.admm_init(scaled, params)
    carry, _ = tadmm.admm_segment_step(carry, scaled, scaling, params,
                                       l1w, l1c)
    return tadmm.segment_kernel_call(carry, scaled, params, l1w, l1c)


def _lane(a, lanes, batch):
    """``a`` cut to ``lanes`` of its leading batch axis where it has one."""
    if a is None or a.dim() == 0 or a.shape[0] != batch:
        return a
    return a[lanes]


def twin_reference(plain, args, kw):
    """The plain twin on a kernel's inputs: its float64 answer
    (``f64``), its f32 run on the inputs' device (``f32``) and, per
    output, each summation order's distance to the float64 answer
    (``orders``: name -> list) and their largest (``noise``)."""
    import torch

    batch = args[-1].shape[0]
    out_64 = plain(*(None if a is None else a.double() for a in args), **kw)
    out_p = plain(*args, **kw)
    rev = torch.arange(batch - 1, -1, -1, device=args[-1].device)
    reversed_out = plain(*(_lane(a, rev, batch) for a in args), **kw)
    picked = (list(range(batch)) if batch <= TWIN_LANES else
              sorted({int(round(v)) for v in
                      torch.linspace(0, batch - 1, TWIN_LANES).tolist()}))
    per_lane = [plain(*(_lane(a, slice(i, i + 1), batch) for a in args),
                      **kw) for i in picked]
    runs = {
        "card": (out_p, None),
        "cpu": (plain(*(None if a is None else a.cpu() for a in args),
                      **kw), None),
        "reversed": (tuple(o[rev] for o in reversed_out), None),
        "lanes": (tuple(torch.cat(o) for o in zip(*per_lane)), picked),
    }
    orders = {}
    for name in TWIN_ORDERS:
        out, lanes = runs[name]
        dists = []
        for o, e in zip(out, out_64):
            ref = e if lanes is None else e[lanes]
            dists.append(float((o.double().to(ref.device) - ref)
                               .abs().max()))
        orders[name] = dists
    noise = [max(orders[name][i] for name in TWIN_ORDERS)
             for i in range(len(out_64))]
    return {"f32": out_p, "f64": out_64, "orders": orders, "noise": noise}


def twin_margins(out_k, ref, kw, beside=None):
    """Per output, (passed, |kernel - f64|, noise, scale) by the rule
    above; ``beside`` (another f32 implementation's outputs on the same
    inputs) joins the noise."""
    import torch

    floor = ULPS_PER_ITER * kw["n_iters"] * F32_EPS
    res = []
    for i, (a, c) in enumerate(zip(out_k, ref["f64"])):
        scale = float(ref["f64"][SCALE_OF[i]].abs().max())
        e_k = float((a.double().to(c.device) - c).abs().max())
        noise = ref["noise"][i]
        if beside is not None:
            noise = max(noise, float((beside[i].double().to(c.device) - c)
                                     .abs().max()))
        ok = bool(torch.isfinite(a).all()) and (
            e_k <= KERNEL_VS_PLAIN * noise + floor * scale)
        res.append((ok, e_k, noise, scale))
    return res, floor


def check_twin(out_k, ref, kw):
    """The kernel against its plain twin by the rule above (``ref`` from
    :func:`twin_reference`); returns (passed, max |kernel - plain|, max
    relative, the floor in ulps of the scale)."""
    margins, floor = twin_margins(out_k, ref, kw)
    errs, rels = [], []
    for i, (ok, e_k, noise, scale) in enumerate(margins):
        err = float((out_k[i] - ref["f32"][i]).abs().max())
        errs.append(err)
        rels.append(err / scale if scale > 0 else err)
        orders = "  ".join(f"{name} {ref['orders'][name][i]:.3e}"
                           for name in TWIN_ORDERS)
        print(f"  {OUT_NAMES[i]:>3}: |kernel-plain| {err:.3e}  "
              f"|kernel-f64| {e_k:.3e}  |plain-f64| by order: {orders}  "
              f"scale {scale:.3e}{'' if ok else '  FAIL'}")
    return all(m[0] for m in margins), max(errs), max(rels), floor


def ragged_twin_checks():
    """Every form of every kernel family (cluster, streaming and, for
    the factored one, device-memory; for the dense one also L^-1 on 16
    ranks and K^-1 with a streamed tail holding none or half of each
    rank's rows in shared memory, the instances of the wide rungs),
    each called by name where the router would pick the cluster form,
    at the ragged widths of the gpu tests (n = 5, 13, 37, where 16
    ranks leave some without a column; one and three rows; one
    iteration and a whole segment), held by the twin rule. Prints per
    case the worst output's margin (|kernel - f64| over the rule's
    bound; above 1 fails) under the noise model and, beside it, under
    the card run of the twin alone (the rule before the noise model)."""
    import numpy as np
    import torch

    from porqua_tpu_torch.ops import admm_kernel as tk

    named = {tk.admm_segment: tk._admm_segment_form,
             tk.admm_segment_factored: tk._admm_segment_factored_form}
    twin = {tk.admm_segment: tk.admm_segment_ref,
            tk.admm_segment_factored: tk.admm_segment_factored_ref}
    families = [("triangular", None), ("inverse", None),
                ("factored_refine0", 0), ("factored_refine0", 1),
                ("factored_refine0", 2)]
    # (form, forced layout) of each family
    forms_of = {"triangular": [("stream", {}), ("cluster", {}),
                               ("cluster", {"ranks": 16})],
                "inverse": [("stream", {}), ("cluster", {}),
                            ("tail", {"rows": 0}), ("tail", {"rows": "half"})],
                "factored": [("stream", {}), ("cluster", {}),
                             ("global", {})]}
    label_of = lambda form, layout: form + "".join(
        f" {k}={v}" for k, v in layout.items())
    forms = list(dict.fromkeys(label_of(f, lay) for v in forms_of.values()
                               for f, lay in v))
    worst = dict.fromkeys(forms, 0.0)
    worst_card = dict.fromkeys(forms, 0.0)
    for family, refine in families:
        for n in (5, 13, 37):
            for m in (1, 3):
                fn, args, kw0 = small_kernel_call(family, np.float32, n=n,
                                                  m=m, refine=refine)
                args = tuple(a.cuda() for a in args)
                for n_iters in (1, 25):
                    kw = dict(kw0, n_iters=n_iters)
                    ref = twin_reference(twin[fn], args, kw)
                    for form, layout in forms_of[
                            family if refine is None else "factored"]:
                        forced = {k: n // 2 if v == "half" else v
                                  for k, v in layout.items()}
                        out = named[fn](form, *args, **kw, **forced)
                        torch.cuda.synchronize()
                        margins, floor = twin_margins(out, ref, kw)
                        rule, card = [], []
                        for i, (ok, e_k, noise, scale) in enumerate(margins):
                            rule.append(e_k / (KERNEL_VS_PLAIN * noise
                                               + floor * scale))
                            card.append(e_k / (KERNEL_VS_PLAIN
                                               * ref["orders"]["card"][i]
                                               + floor * scale))
                        i = int(np.argmax(rule))
                        shown = label_of(form, layout)
                        label = (f"{family if refine is None else 'factored'}"
                                 f"{'' if refine is None else f' r{refine}'}"
                                 f" n={n} m={m} iters={n_iters} {shown}")
                        worst[shown] = max(worst[shown], rule[i])
                        worst_card[shown] = max(worst_card[shown], max(card))
                        print(f"ragged {label}: worst {OUT_NAMES[i]} margin "
                              f"{rule[i]:.3f} (card-only rule "
                              f"{max(card):.3f})", flush=True)
                        check(all(mg[0] for mg in margins),
                              f"ragged {label} agrees with its plain twin")
    for form in forms:
        print(f"ragged widths, {form} form: worst margin {worst[form]:.3f} "
              f"under the noise model, {worst_card[form]:.3f} under the "
              f"card run alone", flush=True)


# The shapes where the JAX package's Pallas kernels run and no 8-rank
# cluster form fits (tests/test_torch_cluster_route.py holds the whole
# domain): (family, n, m, window k, refine, batch). The service's
# ladder rungs 1,024 x 128 and 512 x 512 for the dense kinds (L^-1 on
# 16 ranks, K^-1 with a streamed tail or on its 16 ranks, beside the
# one-block form); for the factored one (the device-memory form) the
# 2,048 x 8 rung at a year's window with and without refinement,
# 1,024 x 128, and the sketch-fed 5,000-asset north star at B = 1.
GAP_SHAPES = [("triangular", 1024, 128, 24, None, 3),
              ("triangular", 512, 512, 24, None, 3),
              ("inverse", 1024, 128, 24, None, 3),
              ("inverse", 512, 512, 24, None, 3),
              ("factored_refine0", 2048, 8, 252, 0, 1),
              ("factored_refine0", 2048, 8, 252, 1, 1),
              ("factored_refine0", 1024, 128, 252, 0, 1),
              ("factored_refine0", 5000, 1, 256, 0, 1)]


def gap_rows(rows):
    """The form that serves each of GAP_SHAPES, called by name, on the
    kernel call of a small tracking batch's second segment: held by the
    twin rule, timed (CUDA events, median of 20) beside its twin, its
    bound and the bytes it moves. For the dense shapes, the one-block
    streaming form keeps its row beside the routed form's, as the
    yardstick. No run of the main path launches these calls, so the
    rows' launches are 0. Returns the rows' keys."""
    import numpy as np
    import torch

    from porqua_tpu_torch.ops import admm_kernel as tk

    keys = []
    for family, n, m, k, refine, batch in GAP_SHAPES:
        fn, args, kw = small_kernel_call(family, np.float32, n=n, m=m,
                                         window=k, batch=batch,
                                         refine=refine)
        args = tuple(a.cuda() for a in args)
        key = ("gap",) + (family, n, m, k, refine)
        if fn is tk.admm_segment:
            chosen = tk.dense_form(n, m, kw["triangular"])
            kind = "trinv" if kw["triangular"] else "inverse"
            shown = ["stream"] + ([chosen] if chosen != "stream" else [])
            for form in shown:
                rname = (f"admm_segment[{family}]_{form}, gap {n}x{m} "
                         f"B={batch}")
                kernel_row(rows, key if form == "stream" else key + (form,),
                           rname, (kind, "stream" if form == "stream"
                                   else "cluster"), fn, args, kw, 0,
                           form=form)
                keys.append(key if form == "stream" else key + (form,))
        else:
            chosen = tk.factored_form(n, m, k, refine)
            rname = (f"admm_segment_factored_global[refine={refine}], gap "
                     f"{n}x{m} k={k} B={batch}")
            kernel_row(rows, key, rname, ("woodbury", "cluster"), fn, args,
                       kw, 0, form="global")
            keys.append(key)
        print(f"gap {n}x{m}: the router picks the {chosen} form", flush=True)
    return keys


def usa_service(X, bm, rebdates, meta, features=None, selection=None):
    """``examples/backtest_usa.py``'s configuration 1 (budget and box,
    LeastSquares) as a BacktestService of the port; ``selection`` (a
    bibfn and its keywords) adds a selection item ``ltr`` that reads
    ``features``."""
    import porqua_tpu_torch as pt
    from porqua_tpu_torch import builders as tb

    O = pt.OptimizationItemBuilder
    data = {"return_series": X, "bm_series": bm}
    items = {"data": pt.SelectionItemBuilder(bibfn=tb.bibfn_selection_data)}
    if selection is not None:
        data["features"] = features
        bibfn, kw = selection
        items["ltr"] = pt.SelectionItemBuilder(bibfn=bibfn, **kw)
    return pt.BacktestService(
        data=data,
        selection_item_builders=items,
        optimization_item_builders={
            "returns": O(bibfn=tb.bibfn_return_series, width=meta["width"]),
            "bm": O(bibfn=tb.bibfn_bm_series, width=meta["width"],
                    align=True),
            "budget": O(bibfn=tb.bibfn_budget_constraint),
            "box": O(bibfn=tb.bibfn_box_constraints, upper=meta["upper"])},
        optimization=pt.LeastSquares(),
        settings={"rebdates": rebdates, "quiet": True})


def usa_weights(strategy, rebdates, columns):
    """A strategy's weights by rebalance date over ``columns``: (date,
    asset), NaN where a date holds no weight for the asset."""
    return strategy.get_weights_df().reindex(
        index=rebdates, columns=columns).to_numpy(float)


def usa_te(problems64, w, columns, width):
    """Per date the in-sample tracking error sqrt(||X w - y||^2 / width)
    of (date, asset) weights ``w`` over ``columns`` (NaN is no weight),
    from the f64 BatchProblems ``problems64`` on the host."""
    import numpy as np
    import torch

    idx = {a: j for j, a in enumerate(columns)}
    w = np.nan_to_num(w)
    x = np.zeros(tuple(problems64.qp.q.shape))
    for i, uni in enumerate(problems64.universes):
        x[i, :len(uni)] = w[i, [idx[a] for a in uni]]
    val = problems64.qp.objective_value(torch.tensor(x)).numpy()
    return np.sqrt(np.maximum(val, 0.0) / width)


def usa_checks(tag, ref, problems64, columns, meta, prm, iters, w, held,
               w_iter, ref_w, ref_iter, iter64):
    """``examples/backtest_usa.py`` configuration 1's checks on one run
    (its optimum is a face, ROADMAP section C, so the weights are held
    through the ADMM iterate and the in-sample TE, not by |dw|):
    - the weights ``w`` (date, asset; NaN where not held) on exactly the
      ``held`` assets of each date, finite, inside the budget and the box
      to eps_abs;
    - the ADMM iterate ``w_iter`` (the same run with polish off) per date
      within KERNEL_VS_PLAIN times ``ref_iter``'s distance to the f64
      iterate ``iter64``, plus ULPS_PER_ITER f32 ulps of the box per
      iteration;
    - the in-sample TE per date within KERNEL_VS_PLAIN times that of
      ``ref_w``, the weights of the run ``ref`` names.
    Returns the iterates' distances to ``iter64`` (this run's, ref's)
    and the two in-sample TEs."""
    import numpy as np

    wz = np.nan_to_num(w)
    check(np.array_equal(~np.isnan(w), held)
          and float(np.abs(wz.sum(1) - 1).max()) <= prm.eps_abs
          and float(wz.min()) >= -prm.eps_abs
          and float(wz.max()) <= meta["upper"] + prm.eps_abs,
          f"[{tag}] weights on the selected assets of every date, finite, "
          f"budget and box hold to {prm.eps_abs:g}")
    floor = ULPS_PER_ITER * int(iters.max()) * F32_EPS * meta["upper"]
    d_run = np.abs(np.nan_to_num(w_iter) - np.nan_to_num(iter64)).max(axis=1)
    d_ref = np.abs(np.nan_to_num(ref_iter) - np.nan_to_num(iter64)).max(
        axis=1)
    check(bool(np.all(d_run <= KERNEL_VS_PLAIN * d_ref + floor)),
          f"[{tag}] ADMM iterate per date within {KERNEL_VS_PLAIN:g}x "
          f"{ref}'s distance to the f64 iterate (+{floor:.2g}; max "
          f"{d_run.max():.3e} and {d_ref.max():.3e})")
    te = usa_te(problems64, w, columns, meta["width"])
    te_ref = usa_te(problems64, ref_w, columns, meta["width"])
    check(bool(np.all(te <= KERNEL_VS_PLAIN * te_ref)),
          f"[{tag}] in-sample TE per date within {KERNEL_VS_PLAIN:g}x "
          f"{ref}'s (max ratio {float(np.max(te / te_ref)):.3f})")
    return d_run, d_ref, te, te_ref


LTR_HORIZONS = (21, 63, 126, 252)
LTR_VOL_DAYS = 63


def usa_features(X):
    """The LTR ranker's (date, asset) feature panel from a return frame:
    at each month's last trading day, the trailing 21-, 63-, 126- and
    252-day compounded returns and the 63-day volatility (the standard
    deviation of daily returns, ddof 1). Month ends with less than 252
    days of history are left out. float64."""
    import numpy as np
    import pandas as pd

    R = X.to_numpy(np.float64)
    cum = np.vstack([np.zeros((1, R.shape[1])), np.cumsum(np.log1p(R), 0)])
    month_ends = pd.Series(np.arange(len(X)), index=X.index).resample(
        "ME").last().to_numpy()
    frames = {}
    for t in month_ends:
        if t + 1 < max(LTR_HORIZONS):
            continue
        cols = {f"ret{h}": np.expm1(cum[t + 1] - cum[t + 1 - h])
                for h in LTR_HORIZONS}
        cols[f"vol{LTR_VOL_DAYS}"] = R[t + 1 - LTR_VOL_DAYS:t + 1].std(
            axis=0, ddof=1)
        frames[X.index[t]] = pd.DataFrame(cols, index=X.columns)
    return pd.concat(frames, axis=0)


# Phase 12 (the ML selection models) holds the card against the JAX
# golden ``ml_golden.npz`` (XLA-CPU, f32, written by
# ``tests/test_torch_models.py --write-golden``), which also carries
# each run in float64. The pairwise ranker is held per date after its
# first ``early_epochs`` (25) epochs, where XLA-CPU's f32 run still sits
# within 3e-6 of its scale from its f64 run: the scores (centred: the
# output bias gets no gradient from a pairwise loss, only rounding noise)
# and the per-epoch losses by the twin rule (twin_rule); the same run on
# features rounded to bfloat16 must fail it on every date. The 300
# full-batch Adam epochs are chaotic in f32: XLA-CPU's own f32 scores sit
# up to tens of percent of their scale from its f64 run on most dates
# (one date within 1e-6), the port's f32 run on the CPU as far, and
# their selected sets differ by up to 19 names in 260. So there the
# centred scores are held only by the twin rule pooled over the dates,
# as a second check: the mean over
# the dates of the card's distance to the f64 run, relative to each
# date's scale, at most KERNEL_VS_PLAIN times XLA-CPU's mean plus
# ULPS_PER_ITER f32 ulps per epoch (the untrained ranker must fail it);
# a name may enter or leave the top k only where its golden score lies
# within that bound (times the date's scale) of the golden's
# k-th/(k+1)-th boundary. The backtest that the card's selection feeds is held on
# every date by the twin rule against the plain path on the same
# problems in f64, and the golden's own selection, solved through the
# same kernels, as backtest_phase holds configuration 1. The LSTM
# forward and training runs, the ordinal fits and the regressions agree
# with XLA-CPU to rounding (CPU parity tests): the LSTM runs by the twin
# rule against the golden's f64 runs, with a control that skips the
# optimizer step; the fits at their optimum within ML_OPT_ATOL (the JAX
# package's own test holds its fit to scipy's BFGS at 2e-2) and the NLL
# within ML_NLL_ATOL; the regressions within ML_REG_RTOL of each
# output's scale (PCA's components up to a sign per row).
ML_PATH = os.path.join("porqua_tpu_torch", "testdata", "ml_golden.npz")
LSTM_NPZ = os.path.join("porqua_tpu_torch", "testdata", "lstm_msci.npz")
ML_OPT_ATOL = 2e-3
ML_NLL_ATOL = 1e-5
ML_REG_RTOL = 1e-4
ML_NDCG_ATOL = 1e-6


def lstm_series(seed, n_days, n_assets):
    """A synthetic daily return series (n_days, n_assets), float32:
    AR(1) per asset (phi 0.85-0.95) on 1% shocks, so the next day is
    predictable from the window."""
    import numpy as np

    rng = np.random.default_rng(seed)
    phi = np.linspace(0.85, 0.95, n_assets)
    eps = 0.01 * rng.standard_normal((n_days, n_assets))
    R = np.zeros((n_days, n_assets))
    for t in range(1, n_days):
        R[t] = phi * R[t - 1] + eps[t]
    return R.astype(np.float32)


def ordinal_data(seed, n, d, n_classes):
    """Latent-variable rows ``y* = X beta + eps`` cut at the latent
    quantiles into ``n_classes`` ordered labels: (X float32, y int)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    latent = X @ (0.5 * rng.standard_normal(d)) + rng.standard_normal(n)
    cuts = np.quantile(latent, np.linspace(0, 1, n_classes + 1)[1:-1])
    return X, np.searchsorted(cuts, latent)


def usa_panel(X, features):
    """The monthly regression panel: each (month end, asset) row of
    ``features`` with its forward 21-day compounded return; rows
    without 21 days ahead are left out. (X float32, y float32)."""
    import numpy as np

    R = X.to_numpy(np.float64)
    pos = {d: i for i, d in enumerate(X.index)}
    rows, ys = [], []
    for d in features.index.get_level_values(0).unique():
        t = pos[d]
        if t + LTR_HORIZONS[0] >= len(X):
            continue
        rows.append(features.xs(d, level=0).to_numpy(np.float64))
        ys.append(np.prod(1.0 + R[t + 1:t + 1 + LTR_HORIZONS[0]], 0) - 1.0)
    return (np.concatenate(rows).astype(np.float32),
            np.concatenate(ys).astype(np.float32))


def tree_of(arrays, prefix):
    """A nested parameter tree from the flat ``prefix``-ed keys
    ``a/b/c`` of an npz."""
    tree = {}
    for key in arrays.files:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arrays[key]
    return tree


@contextlib.contextmanager
def fitted_rankers(module):
    """Context: ``module.PairwiseRanker`` (``module`` the port's ltr
    module or the JAX package's) appends every ranker that it fits to
    the list this yields, so that a caller of ``ltr_selection_scores``
    reads each fit's per-epoch losses (``_losses``)."""
    fitted = []
    base = module.PairwiseRanker

    class Recorded(base):
        def fit(self, groups, **kw):
            fitted.append(super().fit(groups, **kw))
            return self

    module.PairwiseRanker = Recorded
    try:
        yield fitted
    finally:
        module.PairwiseRanker = base


def ml_phase(rows, reset_counts, device="cuda"):
    """Phase 12: the ML selection models on ``device`` (the card) against
    ``ml_golden.npz``; returns the kernel rows it adds to ``rows``.

    ``ltr_usa``: ``examples/backtest_usa.py``'s configuration 1 at full
    width (520 assets, window 252) on its first 12 rebalance dates, with
    a selection item ``bibfn_selection_ltr`` (top_k 260, train_dates 12,
    horizon 21, epochs 300) over ``usa_features``. Checks:
    - per date, the ranker trained here from the golden's initial
      parameters for ``early_epochs``: its centred scores and per-epoch
      losses by the twin rule against the golden's f64 run, which the
      run on bfloat16-rounded features must fail on every date;
    - per date, the ranker trained for 300 epochs: its centred scores
      by the pooled twin rule above, which the untrained ranker's
      scores must fail;
      every name that enters or leaves the top k has its golden score
      within that bound of the golden's boundary (the swaps printed);
    - ``run_batch`` through the LTR item for ``usa_trinv`` (K2) and
      ``usa_woodbury`` (K1 refine 1), B = 12, n = 260: the config's
      cluster form launched, its streaming form and the other wrapper
      never; on every date status equal to the plain path's on the same
      problems and ``usa_checks`` against the plain path (weights on
      the ranker's selection above);
    - the golden's selection solved through the same kernels: status
      and iterations equal the golden's on every date and
      ``usa_checks`` against the golden;
    - ``bibfn_selection_ltr`` raises no NotImplementedError any more.
    ``lstm_msci``: the shipped ranker (``lstm_msci.npz``, converted from
    ``model/lstm_msci_flax.msgpack``) on the last windows of
    ``lstm_series``: predictions by the twin rule against the golden's
    f64 forward, NDCG@10 per window within ML_NDCG_ATOL.
    ``lstm_train``: ``train_lstm`` from the golden's initial parameters,
    minibatch indices and dropout masks: the per-epoch losses and the
    final predictions by the twin rule against the golden's f64 run; a
    control run with learning rate 0 (no optimizer step) must fail it.
    ``ReferenceLSTM`` from the golden's Keras arrays by the twin rule
    against the f64 forward (``load_reference_lstm``, which needs h5py,
    is tested on the CPU).
    ``ordinal``: ``OrdinalRegression`` (probit, logit) at the golden's
    optimum within ML_OPT_ATOL (coefficients, cutpoints,
    probabilities) and its NLL within ML_NLL_ATOL.
    ``regression``: ``OLS`` on the USA monthly panel (full rank and with
    a dependent column), ``PCA`` and ``PCAOLS``, each within
    ML_REG_RTOL of the output's scale.
    Printed: each part's time, the ranker's fit time per date, and the
    kernels' rows (CUDA events, median of 20 launches)."""
    import importlib.util
    import inspect
    import types

    import numpy as np
    import pandas as pd
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch import builders as tb
    from porqua_tpu_torch.models import lstm as tlstm
    from porqua_tpu_torch.models import ltr as tltr
    from porqua_tpu_torch.models.ordinal import OrdinalRegression
    from porqua_tpu_torch.models.regression import OLS, PCA, PCAOLS
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp import solve as tsolve
    from porqua_tpu_torch.qp.admm import admm_init, segment_kernel_call
    from porqua_tpu_torch.synthetic import (synthetic_usa_np,
                                            usa_benchmark_np, usa_rebdates)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, ML_PATH))
    meta = json.loads(str(golden["meta"]))
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("msgpack", "h5py", "sklearn")}
    print(f"phase 12: importable on this machine: {have}", flush=True)
    check("NotImplementedError" not in inspect.getsource(
        tb.bibfn_selection_ltr),
        "[ltr_usa] bibfn_selection_ltr no longer raises NotImplementedError")
    part_s = {}

    # -- ltr_usa: the ranker per date -------------------------------------
    t0 = time.perf_counter()
    lm = meta["ltr"]
    X, _ = synthetic_usa_np(n_days=lm["n_days"], n_assets=lm["n_assets"])
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)[:lm["n_dates"]]
    feats = usa_features(X)
    init = {d: [{"w": golden["ltr/w0"][i], "b": golden["ltr/b0"][i]},
                {"w": golden["ltr/w1"][i], "b": golden["ltr/b1"][i]}]
            for i, d in enumerate(rebdates)}
    ltr_kw = dict(top_k=lm["top_k"], train_dates=lm["train_dates"],
                  horizon=lm["horizon"], epochs=lm["epochs"],
                  init_params=lambda rebdate, sizes: init[rebdate],
                  device=device)
    centred = lambda v: v - v.mean(axis=-1, keepdims=True)

    def ranked(features, epochs):
        """Per date the ranker's frame, its scores over the columns and
        its per-epoch losses, and the fit times (ms)."""
        holder = types.SimpleNamespace(data={"return_series": X,
                                             "features": features})
        frames, losses, fit_ms = {}, [], []
        for d in rebdates:
            sync()
            t1 = time.perf_counter()
            with fitted_rankers(tltr) as fitted:
                frames[d] = tltr.ltr_selection_scores(
                    holder, d, **{**ltr_kw, "epochs": epochs})
            sync()
            fit_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(fitted[0]._losses.cpu().numpy())
        scores = np.stack([frames[d]["values"].reindex(X.columns).to_numpy(
            np.float64) for d in rebdates])
        return frames, scores, np.stack(losses), fit_ms

    # Per date after the first epochs, where the f32 run still follows
    # the f64 one. Control: the same run on features rounded to bfloat16.
    early = lm["early_epochs"]

    def early_rule(tag, scores, losses):
        ok_s, d_s, b_s = twin_rule(centred(scores),
                                   centred(golden["ltr/early_scores"]),
                                   centred(golden["ltr/early_scores_f64"]))
        ok_l, d_l, b_l = twin_rule(losses, golden["ltr/early_losses"],
                                   golden["ltr/early_losses_f64"])
        print(f"[{tag}] after {early} epochs, distance to the f64 run over "
              f"the band per date: centred scores "
              f"{np.round(d_s / b_s, 3).tolist()}, losses "
              f"{np.round(d_l / b_l, 3).tolist()}", flush=True)
        return ok_s & ok_l

    _, s_early, l_early, early_ms = ranked(feats, early)
    check(bool(early_rule("ltr_usa", s_early, l_early).all()),
          f"[ltr_usa] after {early} epochs the centred scores and the "
          f"per-epoch losses within the twin rule on every date")
    bf16 = pd.DataFrame(torch.tensor(feats.to_numpy(np.float32)).to(
        torch.bfloat16).double().numpy(), index=feats.index,
        columns=feats.columns)
    check(not bool(early_rule("ltr_usa control: bfloat16 features",
                              *ranked(bf16, early)[1:3]).any()),
          "[ltr_usa control: features rounded to bfloat16] the rule fails "
          "it on every date")

    picked, scores, _, fit_ms = ranked(feats, lm["epochs"])
    sel = np.stack([picked[d]["binary"].reindex(X.columns).to_numpy() == 1
                    for d in rebdates])
    g32, g64 = golden["ltr/scores"], golden["ltr/scores_f64"]
    gsel = golden["ltr/binary"] == 1
    print(f"[ltr_usa] ranker fit per date (ms, {lm['epochs']} epochs, "
          f"1-{lm['train_dates']} groups of {lm['n_assets']}): "
          f"{[round(t, 1) for t in fit_ms]}; at {early} epochs "
          f"{[round(t, 1) for t in early_ms]}", flush=True)
    # Pooled over the dates: the mean of each date's distance relative
    # to its scale. Control: the untrained ranker (0 epochs, the initial
    # parameters' scores) must fail the rule.
    scale = np.abs(g64).max(axis=1)

    def rel_dist(s):
        return np.abs(centred(s) - centred(g64)).max(axis=1) / scale

    d_card, d_gold = rel_dist(scores), rel_dist(g32)
    bound = (KERNEL_VS_PLAIN * d_gold.mean()
             + ULPS_PER_ITER * lm["epochs"] * F32_EPS)
    untrained = ranked(feats, 0)[1]
    print(f"[ltr_usa] centred scores to the f64 run, relative to the "
          f"scale, per date: card {np.round(d_card, 5).tolist()}, golden "
          f"{np.round(d_gold, 5).tolist()}; means {d_card.mean():.4g} and "
          f"{d_gold.mean():.4g}, bound {bound:.4g}; untrained "
          f"{rel_dist(untrained).mean():.4g}", flush=True)
    check(bool(d_card.mean() <= bound),
          f"[ltr_usa] centred scores within {KERNEL_VS_PLAIN:g}x the "
          f"golden's distance to its f64 run (+{ULPS_PER_ITER} ulps per "
          f"epoch), relative to each date's scale, on the mean of the "
          f"dates")
    check(not bool(rel_dist(untrained).mean() <= bound),
          "[ltr_usa control: the untrained ranker] the rule fails it")
    k = lm["top_k"]
    swaps, ok = [], True
    for i in range(len(rebdates)):
        top = np.sort(g32[i])[::-1]
        edge = 0.5 * (top[k - 1] + top[k])
        moved = sel[i] ^ gsel[i]
        ok &= int(sel[i].sum()) == k and bool(
            np.all(np.abs(g32[i][moved] - edge) <= bound * scale[i]))
        swaps.append(int(moved.sum()) // 2)
    print(f"[ltr_usa] swaps at the top-{k} boundary per date {swaps}; "
          f"selection equal to the golden's on "
          f"{sum(s == 0 for s in swaps)}/{len(rebdates)} dates", flush=True)
    check(ok, f"[ltr_usa] top {k} on every date; names swapped only where "
          f"their golden score lies within the score bound of the "
          f"golden's k-th/(k+1)-th boundary")

    # -- ltr_usa: the backtest the selection feeds ------------------------
    def service(bibfn, **kw):
        return usa_service(X, bm, rebdates, lm, features=feats,
                           selection=(bibfn, kw))

    def problems_of(frames):
        """f32 and f64 BatchProblems of the service on a fixed selection."""
        fixed = service(lambda bs, rebdate, **kw: frames[rebdate])
        return (tbatch.build_problems(fixed),
                tbatch.build_problems(fixed, dtype=torch.float64))

    def solve(problems, prm):
        sol = tbatch.solve_batch(problems, prm, device=device)
        return (usa_weights(tbatch.to_strategy(problems, sol), rebdates,
                            X.columns),
                sol.status.cpu().numpy(), sol.iters.cpu().numpy())

    mine = problems_of(picked)
    theirs = problems_of({d: pd.DataFrame(
        {"values": g32[i], "binary": golden["ltr/binary"][i]},
        index=X.columns) for i, d in enumerate(rebdates)})
    wrappers = {"dense": admm_kernel.admm_segment,
                "factored": admm_kernel.admm_segment_factored}
    part_s["ltr_usa ranker"] = time.perf_counter() - t0
    added = []
    for name, ref_row in (("usa_trinv", "trinv"),
                          ("usa_woodbury", "woodbury_refine1")):
        t0 = time.perf_counter()
        prm = pt.SolverParams(**{**json.loads(str(golden[f"{name}/params"])),
                                 "backend": "pallas"})
        kind = "factored" if prm.linsolve == "woodbury" else "dense"
        wrapper, other = wrappers[kind], wrappers[
            "dense" if kind == "factored" else "factored"]
        sync()
        reset_counts()
        t1 = time.perf_counter()
        bt = tbatch.run_batch(service(tb.bibfn_selection_ltr, **ltr_kw),
                              prm, device=device)
        sync()
        run_ms = (time.perf_counter() - t1) * 1e3
        launches = {"cluster": wrapper.cluster_launches,
                    "stream": wrapper.stream_launches,
                    "other": other.launches}
        w = usa_weights(bt.strategy, rebdates, X.columns)
        status = bt.output["batch"]["status"]
        iters = bt.output["batch"]["iters"]

        # The same problems on the plain path, in f32 and f64.
        off = dataclasses.replace(prm, polish=False)
        plain = dataclasses.replace(prm, backend="xla")
        plain_off = dataclasses.replace(off, backend="xla")
        w0 = solve(mine[0], off)[0]
        wp, plain_status, plain_iters = solve(mine[0], plain)
        wp0 = solve(mine[0], plain_off)[0]
        w64 = solve(mine[1], plain_off)[0]
        B, n = mine[0].qp.q.shape
        print(f"[{name}] run_batch through the LTR item {run_ms:.1f} ms "
              f"({len(rebdates)} ranker fits and the solve); shape B={B} "
              f"n={n}; launches {launches}; solved "
              f"{int((status == 1).sum())}/{B}; iters {iters.tolist()} "
              f"(plain path {plain_iters.tolist()})", flush=True)
        check(launches["cluster"] > 0 and launches["stream"] == 0
              and launches["other"] == 0,
              f"[{name}] run_batch launched the {kind} cluster form, never "
              f"its streaming form nor the other kernel")
        check(np.array_equal(status, plain_status),
              f"[{name}] status equals the plain path's on every date")
        usa_checks(name, "the plain path", mine[1], X.columns, lm, prm, iters,
                   w, sel, w0, wp, wp0, w64)

        # The golden's selection through the same kernels, held as
        # backtest_phase holds configuration 1.
        wg, st_g, it_g = solve(theirs[0], prm)
        wg0 = solve(theirs[0], off)[0]
        g_w = golden[f"{name}/weights"]
        check(np.array_equal(st_g, golden[f"{name}/status"])
              and np.array_equal(it_g, golden[f"{name}/iters"]),
              f"[{name}] on the golden's selection: status and iterations "
              f"equal the golden's on every date")
        usa_checks(f"{name} on the golden's selection", "the golden",
                   theirs[1], X.columns, lm, prm, it_g, wg, gsel, wg0, g_w,
                   golden[f"{name}/weights_nopolish"],
                   golden[f"{name}/weights_nopolish_f64"])
        print(f"[{name}] on the golden's selection: max|dw| vs golden "
              f"{float(np.abs(np.nan_to_num(wg) - g_w).max()):.3e}",
              flush=True)

        # The segment kernel at this shape against its plain twin.
        qp_dev = mine[0].qp.to(dev)
        scaled = tsolve._prepare_impl(qp_dev, prm)[0]
        fn, args, kw = segment_kernel_call(admm_init(scaled, prm), scaled,
                                           prm)
        check(fn is wrapper, f"[{name}] the segment kernel is "
              f"{wrapper.__name__}")
        key = (name.replace("usa_", "ltr_"), "cluster")
        kernel_row(rows, key, f"{rows[(ref_row, 'cluster')]['name']}@ltr",
                   (ref_row, "cluster"), fn, args, kw, launches["cluster"])
        added.append(key)
        part_s[f"ltr_usa {name}"] = time.perf_counter() - t0

    # -- lstm_msci: the shipped ranker --------------------------------------
    t0 = time.perf_counter()
    sm = meta["lstm"]
    R = lstm_series(sm["seed"], sm["n_days"], sm["n_assets"])
    Xw, yw = tlstm.make_windows(R, sm["window"])
    Xm, ym = Xw[-sm["n_windows"]:], yw[-sm["n_windows"]:]
    artifact = tree_of(np.load(os.path.join(here, LSTM_NPZ)), "")
    cell = artifact["OptimizedLSTMCell_0"]
    model = tlstm.TrainedLSTM(module=tlstm.LSTMRanker(
        n_assets=cell["ii"]["kernel"].shape[0],
        hidden=cell["hi"]["kernel"].shape[0]).to(dev), params=artifact)
    pred = model.predict(Xm)

    def held(tag, card, key, floor_steps):
        """``card`` by the twin rule against the golden's ``key`` and
        its f64 run, with a floor of ULPS_PER_ITER f32 ulps of the
        scale per step; prints the distances."""
        g = golden[f"{key}_f64"]
        ok, d, band = twin_rule(card, golden[key], g, floor=(
            ULPS_PER_ITER * floor_steps * F32_EPS * float(np.abs(g).max())))
        print(f"  {tag}: |card-f64| max {float(d.max()):.3e}, worst ratio "
              f"to the band {float(np.max(d / band)):.3f}", flush=True)
        return bool(ok.all())

    check(held("lstm_msci predictions", pred, "msci/pred", sm["window"]),
          "[lstm_msci] predictions within the twin rule")
    rel = np.argsort(np.argsort(ym, axis=1), axis=1).astype(np.float32)
    nd = tlstm.ndcg(torch.as_tensor(pred, device=dev), rel, k=10).cpu().numpy()
    check(float(np.abs(nd - golden["msci/ndcg"]).max()) <= ML_NDCG_ATOL,
          f"[lstm_msci] NDCG@10 per window within {ML_NDCG_ATOL:g} of the "
          f"golden (mean {float(nd.mean()):.6f}, golden "
          f"{float(golden['msci/ndcg'].mean()):.6f})")
    part_s["lstm_msci"] = time.perf_counter() - t0

    # -- lstm_train -----------------------------------------------------------
    t0 = time.perf_counter()
    tm = meta["lstm_train"]
    Xt, yt = tlstm.make_windows(R, tm["window"])
    draws = dict(init_params=tree_of(golden, "train/init/"),
                 batch_indices=golden["train/idx"],
                 dropout_masks=golden["train/masks"], device=device,
                 **tm["kwargs"])
    n_steps = golden["train/idx"].shape[0]

    def trained(lr):
        res = tlstm.train_lstm(Xt, yt, **{**draws, "learning_rate": lr})
        return res.loss_history, res.predict(Xt[-sm["n_windows"]:])

    def run_held(tag, run):
        return all([held(f"{tag} {key}", out, f"train/{key}",
                         n_steps * tm["window"])
                    for out, key in zip(run, ("loss", "pred"))])

    sync()
    t1 = time.perf_counter()
    run = trained(tm["kwargs"]["learning_rate"])
    sync()
    train_ms = (time.perf_counter() - t1) * 1e3
    print(f"[lstm_train] {n_steps} Adam steps of batch "
          f"{golden['train/idx'].shape[1]} over a {tm['window']}-step "
          f"window: {train_ms:.1f} ms; losses {run[0].tolist()}", flush=True)
    check(run_held("lstm_train", run), "[lstm_train] losses and "
          "predictions within the twin rule")
    check(not run_held("control (no optimizer step)", trained(0.0)),
          "[lstm_train control: learning rate 0] the twin rule fails it")

    Xr, _ = tlstm.reference_lstm_windows(R, golden["ref/W"].shape[0])
    Xr = Xr[-sm["n_windows"]:]
    module = tlstm.ReferenceLSTM(n_assets=golden["ref/Wd"].shape[1],
                                 hidden=golden["ref/U"].shape[0],
                                 n_features=golden["ref/W"].shape[0])
    module.load_state_dict({k: torch.as_tensor(golden[f"ref/{a}"])
                            for k, a in (("kernel_i", "W"), ("kernel_h", "U"),
                                         ("bias", "b"), ("dense_kernel", "Wd"),
                                         ("dense_bias", "bd"))})
    ref = tlstm.TrainedLSTM(module=module.to(dev))
    check(held("ReferenceLSTM predictions", ref.predict(Xr), "ref/pred",
               Xr.shape[1]), "[lstm_train] ReferenceLSTM forward from the "
          "golden's Keras arrays within the twin rule")
    part_s["lstm_train"] = time.perf_counter() - t0

    # -- ordinal -----------------------------------------------------------
    t0 = time.perf_counter()
    om = meta["ordinal"]
    Xo, yo = ordinal_data(om["seed"], om["n"], om["d"], om["n_classes"])
    for distr in ("probit", "logit"):
        sync()
        t1 = time.perf_counter()
        fit = OrdinalRegression(distr=distr, device=device).fit(Xo, yo)
        fit_s = time.perf_counter() - t1
        p = f"ord/{distr}/"
        d = {k: float(np.abs(v - golden[p + k]).max()) for k, v in (
            ("beta", fit.beta_), ("cutpoints", fit.cutpoints_),
            ("proba", fit.predict_proba(Xo[:om["n_proba"]])))}
        d64 = {k: float(np.abs(getattr(fit, f"{k}_") - golden[f"{p}{k}_f64"])
                        .max()) for k in ("beta", "cutpoints")}
        g64 = {k: float(np.abs(golden[p + k] - golden[f"{p}{k}_f64"]).max())
               for k in ("beta", "cutpoints")}
        dnll = abs(fit.nll_ - float(golden[p + "nll"]))
        print(f"[ordinal {distr}] fit {fit_s:.2f} s; vs golden {d}, NLL "
              f"{fit.nll_:.7f} (golden {float(golden[p + 'nll']):.7f}); to "
              f"the f64 optimum: card {d64}, golden {g64}", flush=True)
        check(max(d.values()) <= ML_OPT_ATOL and dnll <= ML_NLL_ATOL,
              f"[ordinal {distr}] coefficients, cutpoints and probabilities "
              f"within {ML_OPT_ATOL:g} of the golden, NLL within "
              f"{ML_NLL_ATOL:g}")
    part_s["ordinal"] = time.perf_counter() - t0

    # -- regression --------------------------------------------------------
    t0 = time.perf_counter()
    P, yp = usa_panel(X, feats)
    n_pred = meta["regression"]["n_pred"]

    def near(tag, got, want):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        check(err <= ML_REG_RTOL * scale, f"[regression] {tag} within "
              f"{ML_REG_RTOL:g} of its scale ({err:.3e} of {scale:.3e})")

    for tag, design in (("full", P), ("deficient",
                                      np.hstack([P, P[:, :1] + P[:, 1:2]]))):
        ols = OLS(add_constant=True, device=device).fit(design, yp)
        near(f"OLS {tag} coefficients", ols.coef_, golden[f"reg/ols_{tag}"])
        near(f"OLS {tag} predictions", ols.predict(design[:n_pred]),
             golden[f"reg/ols_{tag}_pred"])
    pca = PCA(meta["regression"]["n_components"], device=device).fit(P)
    sign = np.sign(np.sum(pca.components_ * golden["reg/pca"], axis=1))
    near("PCA components (up to sign)", sign[:, None] * pca.components_,
         golden["reg/pca"])
    near("PCA explained variance ratio", pca.explained_variance_ratio_,
         golden["reg/pca_evr"])
    pols = PCAOLS(meta["regression"]["n_components"], device=device).fit(
        P, yp)
    near("PCAOLS predictions", pols.predict(P[:n_pred]),
         golden["reg/pcaols_pred"])
    part_s["regression"] = time.perf_counter() - t0
    print(f"phase 12: parts (s) "
          f"{ {k: round(v, 2) for k, v in part_s.items()} }; in all "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return added


def backtest_phase(rows, reset_counts):
    """The backtest on the card for both configs; returns the kernel
    rows it adds to ``rows`` (keyed like the tracking rows).

    Checks, per config, over all 55 dates:
    - status and iterations equal the golden on every date;
    - the config's kernel went through the form its shape chooses
      (``dense_form`` / ``factored_form``) and never the other;
    - ``usa_checks`` against the golden: weights on every asset, finite,
      budget and box; the card's ADMM iterate (the same run with polish
      off; where the card's polish was rejected its weights are that
      iterate) by the twin rule against the f64 iterate; the in-sample
      tracking error.
    Printed beside them, as the JAX package's numbers to compare: the
    dates whose polish was accepted (on the card, in the golden and in
    its f64 twin), max|dw| against the golden, and the simulated
    tracking error against the golden's.
    """
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.accounting import (performance_summary,
                                             simulate_strategy)
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp import solve as tsolve
    from porqua_tpu_torch.qp.admm import admm_init, segment_kernel_call
    from porqua_tpu_torch.synthetic import (synthetic_usa_np,
                                            usa_benchmark_np, usa_rebdates)

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), BT_PATH))
    meta = json.loads(str(golden["meta"]))
    X, _ = synthetic_usa_np(n_days=meta["n_days"], n_assets=meta["n_assets"])
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)
    check(len(rebdates) == meta["n_dates"],
          f"[backtest] {len(rebdates)} rebalance dates")

    def service():
        return usa_service(X, bm, rebdates, meta)

    def weights(strategy):
        return usa_weights(strategy, rebdates, X.columns)

    problems64 = tbatch.build_problems(service(), dtype=torch.float64)

    # CUDA events around the solve's two device stages.
    spans = {"admm_solve": [], "_polish_iterate": []}

    def timed_stage(fn, store):
        def wrapper(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            store.append((start, stop))
            return out
        return wrapper

    originals = {k: getattr(tsolve, k) for k in spans}
    added = []
    try:
        for k in spans:
            setattr(tsolve, k, timed_stage(originals[k], spans[k]))
        for name, ref_row in (("usa_trinv", "trinv"),
                              ("usa_woodbury", "woodbury_refine1")):
            p = json.loads(str(golden[f"{name}/params"]))
            p["backend"] = "pallas"
            prm = pt.SolverParams(**p)
            dense = prm.linsolve != "woodbury"    # L^-1 (K2), else K1
            wrapper = (admm_kernel.admm_segment if dense
                       else admm_kernel.admm_segment_factored)

            t0 = time.perf_counter()
            problems = tbatch.build_problems(service())
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qp_dev = problems.qp.to("cuda")
            torch.cuda.synchronize()
            h2d_ms = (time.perf_counter() - t0) * 1e3
            B, n = problems.qp.q.shape
            m = problems.qp.l.shape[-1]
            k = problems.qp.Pf.shape[-2]
            form = (admm_kernel.dense_form(n, m, True) if dense else
                    admm_kernel.factored_form(n, m, k, prm.woodbury_refine))

            times = []
            for _ in range(2):   # the first run includes the warm-up
                for v in spans.values():
                    v.clear()
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                bt = tbatch.run_batch(service(), prm)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                launches = {"cluster": wrapper.cluster_launches,
                            "stream": wrapper.stream_launches}
            stage_ms = {k: sum(a.elapsed_time(b) for a, b in v)
                        for k, v in spans.items()}
            w = weights(bt.strategy)
            status = bt.output["batch"]["status"]
            iters = bt.output["batch"]["iters"]

            # The same solve with polish off: the ADMM iterate.
            sol0 = tbatch.solve_batch(problems,
                                      dataclasses.replace(prm, polish=False))
            w0 = weights(tbatch.to_strategy(problems, sol0))
            accepted = np.any(w != w0, axis=1)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim = simulate_strategy(bt.strategy, X, fc=0.0, vc=0.001)
            torch.cuda.synchronize()
            acct_ms = (time.perf_counter() - t0) * 1e3
            te = performance_summary(sim, benchmark=bm.iloc[:, 0])[
                "tracking_error"]

            # The plain path (backend "xla") on the same service.
            plain_prm = dataclasses.replace(prm, backend="xla")
            plain_times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bt_plain = tbatch.run_batch(service(), plain_prm)
                torch.cuda.synchronize()
                plain_times.append((time.perf_counter() - t0) * 1e3)
            w_plain = weights(bt_plain.strategy)
            if name == "usa_trinv":
                profile_run(lambda: tbatch.run_batch(service(), prm),
                            f"backtest [{name}]")

            g_w = golden[f"{name}/weights"]
            g_iter = golden[f"{name}/weights_nopolish"]
            ref64 = golden[f"{name}/weights_nopolish_f64"]
            g_te = float(golden[f"{name}/tracking_error"])
            dw = float(np.abs(w - g_w).max())
            te_rel = abs(te - g_te) / g_te
            check(np.array_equal(status, golden[f"{name}/status"]),
                  f"[{name}] status equals the JAX golden on every date")
            check(np.array_equal(iters, golden[f"{name}/iters"]),
                  f"[{name}] iterations equal the JAX golden on every date")
            d_card, d_gold, te_card, te_gold = usa_checks(
                name, "the golden", problems64, X.columns, meta, prm, iters,
                w, np.ones(w.shape, bool), w0, g_w, g_iter, ref64)
            print(f"backtest [{name}]: host build of {B} problems "
                  f"{host_ms:.1f} ms; host-to-device copy {h2d_ms:.1f} ms; "
                  f"run_batch {times[1]:.1f} ms end to end (first run "
                  f"{times[0]:.1f} ms; plain path "
                  f"{min(plain_times):.1f} ms), of which ADMM solve "
                  f"{stage_ms['admm_solve']:.2f} ms and polish "
                  f"{stage_ms['_polish_iterate']:.2f} ms on the device; "
                  f"accounting (simulate_strategy) {acct_ms:.1f} ms",
                  flush=True)
            print(f"backtest [{name}]: shape B={B} n={n} m={m} k={k}; "
                  f"form {form}; launches {launches}; solved "
                  f"{int((status == 1).sum())}/{B}; iters "
                  f"{sorted(set(iters.tolist()))}; polish accepted on "
                  f"{int(accepted.sum())}/{B} dates (golden "
                  f"{int(golden[f'{name}/polish_accepted'].sum())}, its f64 "
                  f"twin {int(golden[f'{name}/polish_accepted_f64'].sum())}"
                  f"); dates accepted here and not in the golden "
                  f"{np.flatnonzero(accepted & ~golden[f'{name}/polish_accepted']).tolist()}",
                  flush=True)
            print(f"backtest [{name}]: max|dw| vs golden {dw:.3e} "
                  f"(polish off: {float(np.abs(w0 - g_iter).max()):.3e}; "
                  f"plain path {float(np.abs(w_plain - g_w).max()):.3e}); "
                  f"simulated TE {te:.6e} vs golden {g_te:.6e} (rel diff "
                  f"{te_rel:.3e}; f64 twin "
                  f"{float(golden[f'{name}/tracking_error_f64']):.6e}); "
                  f"iterate to f64: card max {d_card.max():.3e}, golden max "
                  f"{d_gold.max():.3e}, largest ratio "
                  f"{float((d_card / d_gold).max()):.3f}; in-sample TE "
                  f"card max {te_card.max():.3e}, golden max "
                  f"{te_gold.max():.3e}", flush=True)
            check(launches[form] > 0 and launches[
                "stream" if form == "cluster" else "cluster"] == 0,
                f"[{name}] run_batch launched the {form} form its shape "
                f"chooses, and never the other")

            # The segment kernel at this shape against its plain twin.
            scaled = tsolve._prepare_impl(qp_dev, prm)[0]
            fn, args, kw = segment_kernel_call(admm_init(scaled, prm),
                                               scaled, prm)
            plain = (admm_kernel.admm_segment_ref if dense
                     else admm_kernel.admm_segment_factored_ref)
            out_k = fn(*args, **kw)
            base = rows[(ref_row, "cluster")]["name"]
            rname = f"{base}@usa"
            print(f"kernel {rname} against its plain twin:", flush=True)
            ok, err, rel, tfloor = check_twin(
                out_k, twin_reference(plain, args, kw), kw)
            check(ok, f"{rname} agrees with its plain twin: per output "
                  f"|kernel-f64| <= {KERNEL_VS_PLAIN:g} noise + "
                  f"{tfloor:.3g} scale")
            flops, nbytes = admm_kernel.launch_cost(rname, args, kw)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
            ms = statistics.median(cuda_times(lambda: fn(*args, **kw), 2, 20))
            plain_ms = cuda_ms(lambda: plain(*args, **kw), 1, 5)
            moved = admm_kernel.launch_traffic(rname, args, kw, form)
            smem, active = cluster_shape(dense, args, kw)
            rows[(name, form)] = {
                "name": rname,
                "route": "cuda",
                "source": rows[(ref_row, "cluster")]["source"],
                "replaces": rows[(ref_row, "cluster")]["replaces"],
                "launches": launches[form],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }
            added.append((name, form))
            print(f"time {rname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {rows[(name, form)]['bound_ms']:.4f} ms "
                  f"({rows[(name, form)]['bound_by']}; {flops:.4g} flop, "
                  f"{nbytes:.4g} B); design moves {moved / 1e9:.4f} GB per "
                  f"launch; {smem} B of shared memory per block, {active} "
                  f"clusters resident at once; max_abs_err {err:.3e} "
                  f"(max_rel {rel:.3e})", flush=True)
    finally:
        for k, fn in originals.items():
            setattr(tsolve, k, fn)
    return added


def kernel_row(rows, key, rname, base, fn, args, kw, launches, form=None):
    """Hold one kernel call against its plain twin (its distance the
    larger of its runs on the card and the CPU), time it and its twin,
    and add its row to ``rows`` under ``key``. ``form`` names the kernel
    form to launch; by default the wrapper picks it by shape."""
    import torch

    from porqua_tpu_torch.ops import admm_kernel

    dense = fn is admm_kernel.admm_segment
    shown = form or form_of(dense, args, kw)
    plain = (admm_kernel.admm_segment_ref if dense
             else admm_kernel.admm_segment_factored_ref)
    named = (admm_kernel._admm_segment_form if dense
             else admm_kernel._admm_segment_factored_form)
    call = ((lambda: fn(*args, **kw)) if form is None
            else (lambda: named(form, *args, **kw)))
    out_k = call()
    torch.cuda.synchronize()
    print(f"kernel {rname} against its plain twin:", flush=True)
    ok, err, rel, tfloor = check_twin(out_k, twin_reference(plain, args, kw),
                                      kw)
    check(ok, f"{rname} agrees with its plain twin: per output |kernel-f64| "
          f"<= {KERNEL_VS_PLAIN:g} noise + {tfloor:.3g} scale")
    flops, nbytes = admm_kernel.launch_cost(rname, args, kw)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    ms = statistics.median(cuda_times(call, 2, 20))
    plain_ms = cuda_ms(lambda: plain(*args, **kw), 1, 5)
    moved = admm_kernel.launch_traffic(rname, args, kw, shown)
    through_l2 = admm_kernel.launch_traffic(rname, args, kw, shown,
                                            level="l2")
    smem, active = SHAPE_OF[shown](dense, args, kw)
    layout = (f"; {dense_layout(args, kw, shown)}"
              if dense and shown in ("cluster", "tail") else "")
    rows[key] = {
        "name": rname,
        "route": "cuda",
        "source": rows[base]["source"],
        "replaces": rows[base]["replaces"],
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }
    print(f"time {rname}: B={args[-1].shape[0]} n_iters={kw['n_iters']}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{rows[key]['bound_ms']:.4f} ms ({rows[key]['bound_by']}; "
          f"{flops:.4g} flop, {nbytes:.4g} B); the {shown} form's design "
          f"model moves {moved / 1e9:.4f} GB per launch from device memory"
          f" (a launch's matrices read again counted once where they fit "
          f"the card's L2), {through_l2 / 1e9:.4f} GB through L2; {smem} B "
          f"of shared memory per block, {active} clusters resident at "
          f"once{layout}; max_abs_err "
          f"{err:.3e} (max_rel {rel:.3e})", flush=True)


def in_sample_te(Xs, ys, w):
    """Per date ``sqrt(mean((X_t w_t - y_t)^2))`` over the window."""
    import numpy as np

    resid = np.einsum("btn,bn->bt", Xs.astype(np.float64),
                      w.astype(np.float64)) - ys
    return np.sqrt(np.mean(resid ** 2, axis=1))


def chain_turnover(w_init, w):
    """sum_t ||w_t - w_{t-1}||_1 along the chain, from ``w_init``."""
    import numpy as np

    prev = np.vstack([w_init[None], w[:-1]])
    return float(np.abs(w - prev).sum())


def same_bits(a, b):
    """Every field of two QPSolutions equal, bit for bit."""
    import torch

    return all((x is None and y is None) or (
        x is not None and y is not None and torch.equal(x, y))
        for x, y in zip(a, b))


def per_date(qp, w0, params, date_problem, x_prev, y_prev):
    """A chain's per-date function alone (``batch._scan_dates`` with the
    per-date problem ``date_problem``): date 0 from ``w0`` and a cold
    start, every date t >= 1 from a given carry of date t - 1
    (``x_prev`` / ``y_prev`` with leading ``(lanes, T)`` axes, ``x_prev``
    also the holdings), rather than from this run's own date t - 1. For
    holding each date against a reference chain without the chain's
    amplification of rounding."""
    import torch

    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.qp.canonical import CanonicalQP
    from porqua_tpu_torch.qp.solve import QPSolution

    sols = []
    for t in range(qp.q.shape[1]):
        q = CanonicalQP(*(None if f is None else f[:, t:t + 1] for f in qp))
        w, x0, y0 = ((w0, None, None) if t == 0 else
                     (x_prev[:, t - 1], x_prev[:, t - 1], y_prev[:, t - 1]))
        sols.append(tbatch._scan_dates(q, w, params, date_problem,
                                       x_init=x0, y_init=y0))
    return QPSolution(*(None if f[0] is None else torch.cat(f, dim=1)
                        for f in zip(*sols)))


def scan_kernel_call(qp, w0, l1w, params, date):
    """The fused-segment call that the first segment of ``date`` makes
    in ``batch._scan_l1_core`` (``qp`` with leading ``(lanes, T)``
    axes): the scaled-frame L1 term and the warm carry that the chain
    hands the kernel there, as ``(wrapper, args, kwargs)`` of
    ``qp.admm.segment_kernel_call``. For holding a kernel against its
    plain twin on the scan's own inputs."""
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.qp.admm import admm_init, segment_kernel_call
    from porqua_tpu_torch.qp.canonical import CanonicalQP
    from porqua_tpu_torch.qp.solve import _prepare_impl

    head = CanonicalQP(*(None if f is None else f[:, :date] for f in qp))
    _, (w_prev, x_prev, y_prev) = tbatch._scan_l1_core(
        head, w0, l1w, params, return_carry=True)
    scaled, _, x0_s, y0_s, l1w_s, l1c_s = _prepare_impl(
        tbatch._date(qp, date), params, x_prev, y_prev,
        l1w.expand_as(w_prev), w_prev)
    return segment_kernel_call(admm_init(scaled, params, x0_s, y0_s),
                               scaled, params, l1w_s, l1c_s)


def scan_phases(rows, reset_counts):
    """The date-chained backtests on the card; returns the kernel rows
    they add to ``rows``. Checks listed in each phase's messages; the
    goldens are the JAX package's on XLA-CPU
    (``porqua_tpu_torch/testdata/scan_golden.npz``, written by
    ``tests/test_torch_scan.py --write-golden``)."""
    import tempfile

    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.checkpoint import (run_batch_checkpointed,
                                             solve_scan_l1_checkpointed)
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.resilience import faults
    from porqua_tpu_torch.synthetic import (synthetic_usa_np,
                                            usa_benchmark_np, usa_rebdates)
    from porqua_tpu_torch.tracking import benchmark_grid_np

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, SCAN_PATH))
    meta = json.loads(str(golden["meta"]))
    T, n, B, tc = (meta["n_dates"], meta["n_assets"], meta["n_columns"],
                   meta["tc"])
    fixed = pt.FIXED_UNIVERSE
    dev = torch.device("cuda")
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment

    def params(phase, **over):
        return pt.SolverParams(**{**json.loads(str(golden[f"{phase}/params"])),
                                  **over})

    def counts(wrapper):
        return {"cluster": wrapper.cluster_launches,
                "stream": wrapper.stream_launches}

    def run(fn):
        """``fn()`` twice (the first includes the warm-up), the launch
        counts set to 0 before and read after each; returns the second
        run's result, wall ms and counts."""
        for _ in range(2):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            got = (counts(K1), counts(K2))
        return out, wall, got

    def np_of(sol):
        return {k: getattr(sol, k).cpu().numpy() for k in
                ("x", "status", "iters")}

    def forced(qp_l, w_first, l1w, prm, gx, gy):
        """Each date solved alone from the golden's carry of the date
        before (its x and y, and its x as the holdings: the golden
        solved every date): the chain's per-date function, without the
        chain's amplification of rounding."""
        return per_date(qp_l, w_first, prm, tbatch._l1_cost(l1w),
                        torch.as_tensor(gx, device=dev),
                        torch.as_tensor(gy, device=dev))

    def against_golden(tag, got, g):
        """Status, iterations and |dw| <= W_ATOL on every date."""
        dw = np.abs(got["x"] - g["x"]).max(axis=-1)
        check(np.array_equal(got["status"], g["status"]),
              f"[{tag}] status equals the JAX golden on every date "
              f"({int((got['status'] == 1).sum())}/{got['status'].size} "
              f"solved)")
        check(np.array_equal(got["iters"], g["iters"]),
              f"[{tag}] iterations equal the JAX golden on every date")
        check(bool(np.isfinite(got["x"]).all()) and got["x"].shape ==
              g["x"].shape and float(dw.max()) <= W_ATOL,
              f"[{tag}] weights finite, shape {got['x'].shape}, per-date "
              f"max|dw| {float(dw.max()):.3e} <= {W_ATOL:g} (median "
              f"{float(np.median(dw)):.3e})")
        return dw

    def free_chain(tag, got, phase, twins, control, hold):
        """The chain as the entry point runs it: status on every date
        (each date's solution meets eps on its own problem, given its
        own carry), finite weights of the golden's shape, and, where
        ``hold``, the weights by the chain twin rule (CHAIN_VS_TWIN): per
        lane, the card's largest distance over the dates to the f64
        chain (the golden's ``x_f64``) at most CHAIN_VS_TWIN times the
        largest of its f32 twins' (XLA-CPU's chain, the golden's ``x``,
        and the same chain on the plain path, ``twins``); ``control``,
        the chain whose holdings never advance, must fail that rule.
        Where not ``hold``, the rule's readings are printed."""
        g = {k: golden[f"{phase}/{k}"] for k in ("x", "status", "iters")}
        check(np.array_equal(got["status"], g["status"])
              and bool(np.isfinite(got["x"]).all())
              and got["x"].shape == g["x"].shape,
              f"[{tag}] status equals the JAX golden on every date "
              f"({int((got['status'] == 1).sum())}/{got['status'].size} "
              f"solved), weights finite, shape {got['x'].shape}")
        x64 = golden[f"{phase}/x_f64"].astype(np.float64)

        def drift(x):
            """Per lane, the largest max|x - x64| over the dates."""
            d = np.abs(x - x64).max(axis=-1)
            return d.reshape(-1, d.shape[-1]).max(axis=-1)

        def fmt(v):
            return [float(f"{e:.3e}") for e in v]

        d_twins = {"XLA-CPU": drift(g["x"]),
                   **{k: drift(v["x"]) for k, v in twins.items()}}
        twin = np.maximum.reduce(list(d_twins.values()))
        d_card, d_ctrl = drift(got["x"]), drift(control["x"])
        rule = (f"[{tag}] the chain's weights by the chain twin rule: per "
                f"lane, the card's largest distance to the f64 chain "
                f"{fmt(d_card)} <= {CHAIN_VS_TWIN:g} x the largest of its "
                f"f32 twins' ({'; '.join(f'{k} {fmt(v)}' for k, v in d_twins.items())}"
                f"); largest ratio {float((d_card / twin).max()):.3f}")
        ctrl = (f"distance to the f64 chain {fmt(d_ctrl)}, largest ratio "
                f"{float((d_ctrl / twin).max()):.1f}")
        if hold:
            check(bool((d_card <= CHAIN_VS_TWIN * twin).all()), rule)
            check(bool((d_ctrl > CHAIN_VS_TWIN * twin).any()),
                  f"[{tag} control: holdings never advanced] the rule fails "
                  f"it: {ctrl}")
        else:
            print(f"{rule} (printed, not held)\n[{tag} control: holdings "
                  f"never advanced] {ctrl} (printed)", flush=True)
        dw = np.abs(got["x"] - g["x"]).max(axis=-1).reshape(-1)
        same = (got["iters"] == g["iters"]).reshape(-1)
        print(f"[{tag}] the free chain: iterations equal the golden on "
              f"{int(same.sum())}/{same.size} dates (first other at flat "
              f"date {int(np.argmin(same)) if not same.all() else None}); "
              f"max|dw| vs golden per date, first 8 "
              f"{np.round(dw[:8], 9).tolist()}, largest "
              f"{float(dw.max()):.3e} at {int(dw.argmax())}", flush=True)
        return g

    def held_still(qp_l, w_first, l1w, prm):
        """The control: the L1 chain with its cost centered on the
        holdings before date 0 on every date."""
        l1 = tbatch._l1_cost(l1w)
        return np_of(tbatch._scan_dates(qp_l, w_first, prm,
                                        lambda qp_t, w: l1(qp_t, w_first)))

    # -- the inputs: one universe, 64 dates, 8 benchmark columns --------
    t0 = time.perf_counter()
    Xs_np, ys_np = pt.synthetic_universe_np(meta["seed"], T, meta["window"],
                                            n)
    Ys_np = benchmark_grid_np(Xs_np, ys_np, B)
    Xs = torch.as_tensor(Xs_np, device=dev)
    qp = pt.build_tracking_qp(Xs, torch.as_tensor(ys_np, device=dev))
    cols = [pt.build_tracking_qp(Xs, torch.as_tensor(y, device=dev))
            for y in Ys_np]
    grid = pt.CanonicalQP(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*cols)))
    del cols
    # The same problems on the host, for the port's plain path on the CPU.
    qp_cpu = pt.build_tracking_qp(torch.as_tensor(Xs_np),
                                  torch.as_tensor(ys_np))
    grid_cpu = pt.CanonicalQP(*(None if f[0] is None else torch.stack(f)
                                for f in zip(*(pt.build_tracking_qp(
                                    torch.as_tensor(Xs_np),
                                    torch.as_tensor(y)) for y in Ys_np))))
    torch.cuda.synchronize()
    print(f"scan inputs: {T} dates x {meta['window']} days x {n} assets, "
          f"{B} benchmark columns, problems built on the card in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    w_init = np.full(n, 1.0 / n, np.float32)
    lanes = tbatch._lanes(qp)
    w0 = torch.as_tensor(w_init, device=dev)[None]
    l1w = tbatch._l1_weight(n, n, tc, torch.float32, dev)
    added = []

    # -- scan_l1: K1 cluster at B = 1, L1 on, warm carry ----------------
    prm = params("scan_l1", backend="pallas")
    sol, wall, (c1, c2) = run(lambda: pt.solve_scan_l1(
        qp, n, w_init, tc, prm, universes=fixed))
    got = np_of(sol)
    plain = dataclasses.replace(prm, backend="xla")
    plain_sol, plain_wall, _ = run(lambda: pt.solve_scan_l1(
        qp, n, w_init, tc, plain, universes=fixed))
    cpu_sol = pt.solve_scan_l1(qp_cpu, n, w_init, tc, plain, universes=fixed,
                               device="cpu")
    g = free_chain("scan_l1", got, "scan_l1",
                   {"plain path, card": np_of(plain_sol),
                    "plain path, CPU": np_of(cpu_sol)},
                   held_still(lanes, w0, l1w, prm), hold=False)
    segs = got["iters"] // prm.check_interval
    check(c1["cluster"] == int(segs.sum()) and c1["stream"] == 0
          and c2["cluster"] + c2["stream"] == 0,
          f"[scan_l1] one K1 cluster launch per segment on every date "
          f"({c1['cluster']} = {int(segs.sum())} segments), no streaming "
          f"or dense launch")
    t0 = time.perf_counter()
    fsol = np_of(pt.QPSolution(*(None if f is None else f[0] for f in forced(
        lanes, w0, l1w, prm, g["x"][None], golden["scan_l1/y"][None]))))
    forced_ms = (time.perf_counter() - t0) * 1e3
    against_golden("scan_l1 per date", fsol, g)
    te, g_te = (in_sample_te(Xs_np, ys_np, fsol["x"]),
                in_sample_te(Xs_np, ys_np, g["x"]))
    te_rel = abs(float(np.median(te)) - float(np.median(g_te))) / float(
        np.median(g_te))
    check(te_rel <= TE_RTOL, f"[scan_l1 per date] median in-sample TE "
          f"{float(np.median(te)):.6e} within {TE_RTOL:g} relative of the "
          f"golden's {float(np.median(g_te)):.6e} ({te_rel:.3e})")
    x64 = golden["scan_l1/x_f64"].astype(np.float64)
    print(f"scan_l1: {wall:.1f} ms end to end for {T} dates "
          f"({wall / T:.2f} ms per date; plain path {plain_wall:.1f} ms; "
          f"the {T} dates from the golden's carry {forced_ms:.1f} ms); "
          f"segments per date {segs.mean():.3f} (iters "
          f"{sorted(set(got['iters'].tolist()))}); launches {c1}; chained "
          f"turnover {chain_turnover(w_init, got['x']):.6f} (golden "
          f"{chain_turnover(w_init, g['x']):.6f}, f64 chain "
          f"{chain_turnover(w_init, x64):.6f}); median in-sample TE "
          f"{float(np.median(in_sample_te(Xs_np, ys_np, got['x']))):.6e} "
          f"(golden {float(np.median(g_te)):.6e}, f64 chain "
          f"{float(np.median(in_sample_te(Xs_np, ys_np, x64))):.6e})",
          flush=True)
    scan_sol = sol
    fn, args, kw = scan_kernel_call(lanes, w0, l1w, prm, 2)
    check(fn is K1 and admm_kernel.factored_form(
        n, 1, args[0].shape[-2], prm.woodbury_refine) == "cluster",
        "[scan_l1] the chain's kernel call is K1 in its cluster form")
    kernel_row(rows, ("scan_l1", "cluster"),
               "admm_segment_factored_cluster[refine=0]@scan",
               ("woodbury", "cluster"), fn, args, kw, c1["cluster"])
    added.append(("scan_l1", "cluster"))
    profile_run(lambda: pt.solve_scan_l1(qp, n, w_init, tc, prm,
                                         universes=fixed), "profile [scan_l1]")

    # -- scan_l1_grid: K2 cluster at B = 8 ------------------------------
    prm_g = params("scan_l1_grid", backend="pallas")
    w_grid = np.tile(w_init, (B, 1))
    w0g = torch.as_tensor(w_grid, device=dev)
    sol_g, wall_g, (c1, c2) = run(lambda: pt.solve_scan_l1_grid(
        grid, n, w_grid, tc, prm_g, universes=fixed))
    got_g = np_of(sol_g)
    plain = dataclasses.replace(prm_g, backend="xla")
    plain_g, plain_wall_g, _ = run(lambda: pt.solve_scan_l1_grid(
        grid, n, w_grid, tc, plain, universes=fixed))
    cpu_g = pt.solve_scan_l1_grid(grid_cpu, n, w_grid, tc, plain,
                                  universes=fixed, device="cpu")
    g_g = free_chain("scan_l1_grid", got_g, "scan_l1_grid",
                     {"plain path, card": np_of(plain_g),
                      "plain path, CPU": np_of(cpu_g)},
                     held_still(grid, w0g, l1w, prm_g), hold=True)
    segs_g = got_g["iters"] // prm_g.check_interval
    check(c2["cluster"] == int(segs_g.max(axis=0).sum()) and c2["stream"] == 0
          and c1["cluster"] + c1["stream"] == 0,
          f"[scan_l1_grid] one K2 cluster launch per segment of every date's "
          f"{B}-lane batch ({c2['cluster']} = {int(segs_g.max(axis=0).sum())}"
          f"), no streaming or factored launch")
    gy_g = golden["scan_l1_grid/y"]
    fsol_g = forced(grid, w0g, l1w, prm_g, g_g["x"], gy_g)
    against_golden("scan_l1_grid per date", np_of(fsol_g), g_g)
    # Lane 0 of the grid against the single-column scan of column 0, each
    # date from the same golden carry.
    col0 = forced(lanes, w0, l1w, prm_g, g_g["x"][:1], gy_g[:1])
    lane0 = pt.QPSolution(*(None if f is None else f[:1] for f in fsol_g))
    c0, l0 = np_of(col0), np_of(lane0)
    d0 = float(np.abs(l0["x"] - c0["x"]).max())
    check(np.array_equal(l0["status"], c0["status"])
          and np.array_equal(l0["iters"], c0["iters"]) and d0 <= W_ATOL,
          f"[scan_l1_grid] lane 0 equals the single-column scan of column 0 "
          f"with the same params, each date from the same carry: status and "
          f"iterations on every date, max|dw| {d0:.3e} <= {W_ATOL:g}; bit "
          f"for bit: {same_bits(lane0, col0)}")
    print(f"scan_l1_grid: {wall_g:.1f} ms end to end for {T} dates x {B} "
          f"columns ({wall_g / T:.2f} ms per date; plain path "
          f"{plain_wall_g:.1f} ms); segments per date "
          f"{segs_g.max(axis=0).mean():.3f} (iters "
          f"{sorted(set(got_g['iters'].ravel().tolist()))}); launches {c2}; "
          f"chained turnover per column "
          f"{[round(chain_turnover(w_init, got_g['x'][b]), 6) for b in range(B)]}"
          f" (golden "
          f"{[round(chain_turnover(w_init, g_g['x'][b]), 6) for b in range(B)]}"
          f")", flush=True)
    fn, args, kw = scan_kernel_call(grid, w0g, l1w, prm_g, 2)
    check(fn is K2 and kw["triangular"] and admm_kernel.dense_form(
        n, 1, True) == "cluster",
        "[scan_l1_grid] the grid's kernel call is K2 in its cluster form")
    kernel_row(rows, ("scan_l1_grid", "cluster"),
               "admm_segment[triangular]_cluster@grid", ("trinv", "cluster"),
               fn, args, kw, c2["cluster"])
    added.append(("scan_l1_grid", "cluster"))
    del grid, grid_cpu, sol_g, fsol_g, plain_g, cpu_g

    # -- scan_l1_checkpointed: crash at the seam, resume ----------------
    crash = faults.Scenario("crash", (faults.FaultSpec.make(
        "backtest.chunk", "crash", start=1, count=1),))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full, info = solve_scan_l1_checkpointed(
            qp, n, w_init, tc, os.path.join(tmp, "full"), prm,
            segment_size=16, universes=fixed)
        torch.cuda.synchronize()
        ck_ms = (time.perf_counter() - t0) * 1e3
        crashed = False
        with faults.active(crash):
            try:
                solve_scan_l1_checkpointed(
                    qp, n, w_init, tc, os.path.join(tmp, "cut"), prm,
                    segment_size=16, universes=fixed)
            except faults.InjectedCrash:
                crashed = True
        t0 = time.perf_counter()
        resumed, info2 = solve_scan_l1_checkpointed(
            qp, n, w_init, tc, os.path.join(tmp, "cut"), prm,
            segment_size=16, universes=fixed)
        torch.cuda.synchronize()
        resume_ms = (time.perf_counter() - t0) * 1e3
        check(crashed and info["total_segments"] == 4
              and info2["resumed_segments"] == 2,
              f"[scan_l1_checkpointed] the crash at the backtest.chunk seam "
              f"after segment 1 ended the run; the rerun resumed "
              f"{info2['resumed_segments']} of {info2['total_segments']} "
              f"segments")
        check(same_bits(resumed, full),
              "[scan_l1_checkpointed] resumed run bit-identical to the "
              "uninterrupted checkpointed run (every field)")
        check(same_bits(full, scan_sol),
              "[scan_l1_checkpointed] checkpointed run bit-identical to "
              "the plain solve_scan_l1 run (every field)")
        print(f"scan_l1_checkpointed: uninterrupted {ck_ms:.1f} ms ({T} dates "
              f"in {info['total_segments']} segments of 16, with the saves); "
              f"resume of the last {info2['total_segments'] - 2} segments "
              f"{resume_ms:.1f} ms", flush=True)

        bt_golden = np.load(os.path.join(here, BT_PATH))
        bmeta = json.loads(str(bt_golden["meta"]))
        X, _ = synthetic_usa_np(n_days=bmeta["n_days"],
                                n_assets=bmeta["n_assets"])
        bm = usa_benchmark_np(X)
        rebdates = usa_rebdates(X.index)
        p = json.loads(str(bt_golden["usa_trinv/params"]))
        prm_u = pt.SolverParams(**{**p, "backend": "pallas"})

        def ck_run(d):
            return run_batch_checkpointed(usa_service(X, bm, rebdates, bmeta),
                                          os.path.join(tmp, d),
                                          chunk_size=16, params=prm_u)

        t0 = time.perf_counter()
        bt_full = ck_run("usa_full")
        torch.cuda.synchronize()
        usa_ms = (time.perf_counter() - t0) * 1e3
        crashed = False
        with faults.active(crash):
            try:
                ck_run("usa_cut")
            except faults.InjectedCrash:
                crashed = True
        bt_res = ck_run("usa_cut")
        wf = bt_full.strategy.get_weights_df().to_numpy(float)
        wr = bt_res.strategy.get_weights_df().to_numpy(float)
        same = np.array_equal(wf, wr) and all(
            np.array_equal(v, bt_res.output["batch"][k])
            for k, v in bt_full.output["batch"].items())
        check(crashed and bt_res.output["checkpoint"]["resumed_chunks"] == 2
              and same,
              f"[run_batch_checkpointed usa_trinv] crashed after chunk 1 of "
              f"{bt_full.output['checkpoint']['total_chunks']}, resumed 2 "
              f"chunks, weights and per-date counters bit-identical to the "
              f"uninterrupted run")
        print(f"run_batch_checkpointed usa_trinv: {usa_ms:.1f} ms end to end "
              f"({len(rebdates)} dates in chunks of 16); solved "
              f"{int((bt_full.output['batch']['status'] == 1).sum())}/"
              f"{len(rebdates)}", flush=True)
    return added


def usa_turnover_inputs(golden):
    """``examples/backtest_usa.py`` configuration 2 as the golden ran it,
    built on the host: the return series, ``build_problems`` (f64) on
    the golden's dates, the pre-backtest holdings (equal weight over the
    set the filter admits on the first date) and the build's ms."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch import builders as tb
    from porqua_tpu_torch.synthetic import (synthetic_usa_np,
                                            usa_benchmark_np, usa_rebdates)

    meta = json.loads(str(golden["meta"]))
    usa = meta["usa"]
    X, V = synthetic_usa_np(n_days=usa["n_days"], n_assets=usa["n_assets"])
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)[:meta["usa_dates"]]
    O = pt.OptimizationItemBuilder

    def service(w0=None):
        return pt.BacktestService(
            data={"return_series": X, "bm_series": bm, "volume_series": V},
            selection_item_builders={
                "volume": pt.SelectionItemBuilder(
                    bibfn=tb.bibfn_selection_min_volume, width=90,
                    min_volume=1e6)},
            optimization_item_builders={
                "returns": O(bibfn=tb.bibfn_return_series, width=USA_WIDTH),
                "bm": O(bibfn=tb.bibfn_bm_series, width=USA_WIDTH,
                        align=True),
                "budget": O(bibfn=tb.bibfn_budget_constraint),
                "box": O(bibfn=tb.bibfn_box_constraints, upper=USA_UPPER),
                "turnover": O(bibfn=tb.bibfn_turnover_constraint,
                              turnover_budget=USA_BUDGET)},
            optimization=pt.LeastSquares(dtype=torch.float64,
                                         l2_penalty=1e-4),
            settings={"rebdates": rebdates, "quiet": True,
                      "prev_weights": dict(w0 or {})})

    probe = service()
    probe.prepare_rebalancing(rebalancing_date=rebdates[0])
    universe = list(probe.optimization.constraints.selection)
    w0 = {a: 1.0 / len(universe) for a in universe}
    t0 = time.perf_counter()
    problems = tbatch.build_problems(service(w0), dtype=torch.float64)
    host_ms = (time.perf_counter() - t0) * 1e3
    w_init = np.array([w0[a] for a in problems.universes[0]])
    return X, problems, w_init, host_ms


def turnover_phase(reset_counts):
    """``examples/backtest_usa.py`` configuration 2 on the card:
    build_problems (f64) -> solve_scan_turnover -> assemble_backtest ->
    simulate_strategy, on the plain torch path (the kernels take f32
    only), against the JAX golden."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.accounting import simulate_strategy
    from porqua_tpu_torch.ops import admm_kernel

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, SCAN_PATH))
    X, problems, w_init, host_ms = usa_turnover_inputs(golden)
    n_assets = len(problems.universes[0])
    rebdates = problems.rebdates
    prm = pt.SolverParams(**json.loads(str(golden["usa_turnover/params"])))
    wrappers = (admm_kernel.admm_segment, admm_kernel.admm_segment_factored)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sol = tbatch.solve_scan_turnover(
        problems.qp, n_assets=n_assets, row_start=1, w_init=w_init,
        params=prm, universes=problems.universes)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    launches = sum(f.launches for f in wrappers)
    bt = tbatch.assemble_backtest(problems, sol)
    sim = simulate_strategy(bt.strategy, X, fc=0.0, vc=0.001)

    status = sol.status.cpu().numpy()
    iters = sol.iters.cpu().numpy()
    w = sol.x[:, :n_assets].cpu().numpy()
    g_w = golden["usa_turnover/x"][:, :n_assets]
    dw = np.abs(w - g_w).max(axis=1)
    spent = np.abs(w - np.vstack([w_init[None], w[:-1]])).sum(axis=1)
    g_spent = np.abs(g_w - np.vstack([w_init[None], g_w[:-1]])).sum(axis=1)
    wdf = bt.strategy.get_weights_df().fillna(0.0)
    realized = wdf.diff().abs().sum(axis=1).iloc[1:]
    T = len(rebdates)
    check(n_assets == int(golden["usa_turnover/n_assets"]),
          f"[usa_turnover] the filter admits {n_assets} of {X.shape[1]} "
          f"assets")
    check(np.array_equal(status, golden["usa_turnover/status"]),
          f"[usa_turnover] status equals the JAX golden on every date "
          f"({int((status == 1).sum())}/{T} solved)")
    same = iters == golden["usa_turnover/iters"]
    check(bool(np.isfinite(w).all()) and float(dw.max()) <= USA_W_ATOL,
          f"[usa_turnover] per-date max|dw| {float(dw.max()):.3e} <= "
          f"{USA_W_ATOL:g}, the configuration's conditioning bound "
          f"(iterations equal the golden on {int(same.sum())}/{T} dates)")
    print(f"[usa_turnover] max|dw| per date: first 8 "
          f"{np.round(dw[:8], 9).tolist()}, median {float(np.median(dw)):.3e}"
          f", largest {float(dw.max()):.3e} at date {int(dw.argmax())}; "
          f"objective rel diff max "
          f"{float(np.max(np.abs(sol.obj_val.cpu().numpy() - golden['usa_turnover/obj_val']) / np.abs(golden['usa_turnover/obj_val']))):.3e}",
          flush=True)
    # Controls: the chain with a deliberate fault in how a date takes the
    # previous holdings, over its first USA_CONTROL_DATES dates (date 0 is
    # the sound run's date 0). The phase's checks (status, |dw|, budget)
    # must fail the first two. The third changes rows that do not bind
    # after date 0 (the budget is spent in full on date 0 only), so no
    # check of the answer can see it: its readings are printed.
    dev = torch.device("cuda")
    nvar = problems.qp.q.shape[-1]
    head = tbatch._lanes(pt.CanonicalQP(*(
        None if f is None else f[:USA_CONTROL_DATES] for f in problems.qp))
        .to(dev))
    w_first = tbatch._holdings(w_init, n_assets, 1, nvar, torch.float64, dev)
    rows = tbatch._turnover_rows(1, n_assets)

    def upper_only(qp_t, w):
        u = qp_t.u.clone()
        u[:, 1:1 + n_assets] = w[:, :n_assets]
        return qp_t._replace(u=u), {}

    for name, hook, must_fail in (
            ("holdings never advanced", lambda qp_t, w: rows(qp_t, w_first),
             True),
            ("the turnover rows written one row early",
             tbatch._turnover_rows(0, n_assets), True),
            ("only the upper turnover rows rewritten", upper_only, False)):
        c = tbatch._scan_dates(head, w_first, prm, hook)
        cw = c.x[0, :, :n_assets].cpu().numpy()
        cdw = np.abs(cw - g_w[:USA_CONTROL_DATES]).max(axis=1)
        c_spent = np.abs(cw - np.vstack([w_init[None], cw[:-1]])).sum(axis=1)
        c_status = c.status[0].cpu().numpy()
        fails = (float(cdw.max()) > USA_W_ATOL
                 or float(c_spent.max()) > USA_BUDGET + 1e-6
                 or not np.array_equal(c_status, golden[
                     "usa_turnover/status"][:USA_CONTROL_DATES]))
        msg = (f"[usa_turnover control: {name}] the phase's checks fail it: "
               f"{fails}; solved {int((c_status == 1).sum())}/"
               f"{c_status.size}, max|dw| {float(cdw.max()):.3e} (limit "
               f"{USA_W_ATOL:g}), per date "
               f"{[float(f'{v:.3e}') for v in cdw]}; spent per date "
               f"{[round(float(v), 6) for v in c_spent]} (budget "
               f"{USA_BUDGET}; the sound chain "
               f"{[round(float(v), 6) for v in spent[:USA_CONTROL_DATES]]})")
        if must_fail:
            check(fails, msg)
        else:
            print(f"{msg} (printed, not held)", flush=True)
    check(bool(np.all(spent <= USA_BUDGET + 1e-6)),
          f"[usa_turnover] turnover budget holds on every date (max spent "
          f"{float(spent.max()):.9f} <= {USA_BUDGET} + 1e-6)")
    check(launches == 0, f"[usa_turnover] f64 on the plain path: "
          f"{launches} kernel launches")
    print(f"usa_turnover: {T} dates, n {problems.qp.q.shape[-1]} (2 x "
          f"{n_assets}), m {problems.qp.l.shape[-1]}, f64; host build "
          f"{host_ms:.1f} ms; solve_scan_turnover {solve_ms:.1f} ms "
          f"({solve_ms / T:.1f} ms per date); segments per date "
          f"{(iters / prm.check_interval).mean():.2f} (iters "
          f"{sorted(set(iters.tolist()))}); realized median turnover "
          f"{float(realized.median()):.6f} (golden "
          f"{float(np.median(g_spent[1:])):.6f}); simulated cumulative net "
          f"return {float((1 + sim).prod() - 1):.6f}", flush=True)


def serve_kernel_call(reqs, params, device):
    """The fused-segment call that the first segment of the service's
    full batch (the first 256 requests, bucket-padded) makes, as
    ``(wrapper, args, kwargs)`` of ``qp.admm.segment_kernel_call``."""
    import torch

    from porqua_tpu_torch.qp.admm import segment_kernel_call
    from porqua_tpu_torch.qp.canonical import stack_qps
    from porqua_tpu_torch.qp.solve import prepare_batch
    from porqua_tpu_torch.serve.bucketing import BucketLadder

    qp = stack_qps([BucketLadder().pad(q)[1] for q in reqs]).to(device)
    x0 = torch.zeros_like(qp.q)
    y0 = torch.zeros_like(qp.l)
    scaled, _, carry, _, _ = prepare_batch(qp, params, x0, y0)
    return segment_kernel_call(carry, scaled, params)


def serve_phase(rows, reset_counts, device="cuda"):
    """The online solve service on ``device`` (the card); returns the
    kernel rows it adds to ``rows`` and each run's burst numbers
    (solves/s, p50 and p99 ms; phase 10 prints them beside its hooked
    bursts). Three runs of the reference
    loadgen's north-star stream (512 tracking requests, 500 assets,
    window 252, seed 5; bucket 512 x 8) through ``SolveService``
    (max_batch 256, max_wait 2 ms, warm starts off, the whole slot
    ladder prewarmed): ``serve_trinv`` (the micro-batcher, dense
    requests, the triangular-inverse kernel), ``serve_woodbury`` (the
    micro-batcher, factored requests, the factored kernel at refine 0)
    and ``serve_continuous`` (the continuous batcher on the dense
    stream, one segment per launch). Each run submits the 512 requests
    as one burst, then runs ``run_loadgen``'s closed loop at 24 in
    flight. Checks, per run, against the JAX golden
    (``porqua_tpu_torch/testdata/serve_golden.npz``):
    - status and iterations of every burst request equal the golden's;
    - max|dx| <= W_ATOL over the 500 real entries of every request;
    - the budget and the long-only box hold to eps_abs;
    - the kernel went through its cluster form, never the streaming one;
    - every result on the card (``cuda:0``), no breaker trip, no failed
      dispatch, no failed, expired or shed request, every future
      resolved; the closed loop without errors, with as many solved as
      the golden;
    - compiles equal what prewarm reported, and none after warmup.
    Printed: throughput, latency percentiles, batches by slot count,
    segments per lane, prewarm seconds per bucket, launches per form,
    and one profiled burst of serve_trinv."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.analysis import sanitize
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.serve import SolveService, slot_ladder
    from porqua_tpu_torch.serve.loadgen import (build_tracking_requests,
                                                run_loadgen)

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, SERVE_PATH))
    meta = json.loads(str(golden["meta"]))
    n = meta["n_assets"]
    dev = torch.device(device)
    label = f"{dev.type}:{dev.index or 0}"
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment
    runs = (("serve_trinv", "trinv", False, K2),
            ("serve_woodbury", "woodbury", False, K1),
            ("serve_continuous", "trinv", True, K2))
    requests = {factor: build_tracking_requests(
        meta["n_requests"], n, meta["window"], meta["seed"], factor)
        for factor in (False, True)}
    launches, calls, bursts = {}, {}, {}

    def burst(svc, reqs):
        tickets = [svc.submit(q) for q in reqs]
        return [svc.result(t, timeout=600) for t in tickets]

    for tag, config, continuous, wrapper in runs:
        p = json.loads(str(golden[f"{config}/params"]))
        params = pt.SolverParams(**{**p, "backend": "pallas"})
        reqs = requests[config == "woodbury"]
        calls[tag] = (params, reqs)
        sanitize.reset()
        reset_counts()
        svc = SolveService(params, max_batch=256, max_wait_ms=2.0,
                           warm_start=False, continuous=continuous,
                           device=device)
        slots = {}
        get = (svc.cache.get_continuous if continuous else svc.cache.get)

        def counted(bucket, s, dtype, dev_=None, get=get, slots=slots):
            slots[s] = slots.get(s, 0) + 1
            return get(bucket, s, dtype, dev_)

        svc.start()
        try:
            t0 = time.perf_counter()
            n_prewarm = svc.prewarm(reqs[0])
            prewarm_s = time.perf_counter() - t0
            setattr(svc.cache, "get_continuous" if continuous else "get",
                    counted)
            t0 = time.perf_counter()
            res = burst(svc, reqs)
            burst_s = time.perf_counter() - t0
            snap = svc.snapshot()
            by_slots = dict(sorted(slots.items()))
            slots.clear()
            report = run_loadgen(reqs, params, inflight=24, max_batch=256,
                                 service=svc, continuous=continuous)
            loop = svc.snapshot()
            loop_slots = dict(sorted(slots.items()))
            post = sanitize.post_warmup_compiles()
            launches[tag] = {"cluster": wrapper.cluster_launches,
                             "stream": wrapper.stream_launches}
            if tag == "serve_trinv":
                profile_run(lambda: burst(svc, reqs),
                            "profile [serve_trinv burst of "
                            f"{len(reqs)}]")
        finally:
            svc.stop()
        status = np.array([r.status for r in res])
        iters = np.array([r.iters for r in res])
        x = np.stack([r.x for r in res])
        g_status = golden[f"{config}/status"]
        dx = np.abs(x - golden[f"{config}/x"]).max(axis=1)
        eps = params.eps_abs
        budget = float(np.abs(x.sum(axis=1) - 1.0).max())
        box = float(max(-x.min(), x.max() - 1.0, 0.0))
        devices = sorted({r.device for r in res})
        print(f"{tag}: prewarm {n_prewarm} entries in {prewarm_s:.2f} s "
              f"({svc.cache.bucket_stats()}); burst of {len(res)} in "
              f"{burst_s * 1e3:.1f} ms ({len(res) / burst_s:.1f} solves/s; "
              f"p50 {snap['latency_p50_ms']:.1f} ms, p99 "
              f"{snap['latency_p99_ms']:.1f} ms; batches by slot count "
              f"{by_slots}); closed loop at 24 in flight: "
              f"{report['throughput_solves_per_s']:.1f} solves/s, p50 "
              f"{report['latency_p50_ms']:.1f} ms, p99 "
              f"{report['latency_p99_ms']:.1f} ms, occupancy "
              f"{report['occupancy_mean']:.3f}, batches by slot count "
              f"{loop_slots}; "
              + (f"segments per lane "
                 f"{loop['lane_segments'] / max(loop['completed'], 1):.3f} "
                 f"(segment occupancy "
                 f"{loop['segment_occupancy_mean']:.3f}); "
                 if continuous else "")
              + f"launches {launches[tag]}; solved "
              f"{int((status == 1).sum())}/{len(status)}, iters "
              f"{sorted(set(iters.tolist()))}; max|dx| {float(dx.max()):.3e} "
              f"(median {float(np.median(dx)):.3e}; XLA-CPU f32 to its f64 "
              f"answer {float(golden[f'{config}/x_f64_gap'].max()):.3e}); "
              f"max|sum x - 1| {budget:.3e}, box violation {box:.3e}",
              flush=True)
        bursts[tag] = {
            "solves_per_s": round(len(res) / burst_s, 1),
            "p50_ms": round(snap["latency_p50_ms"], 1),
            "p99_ms": round(snap["latency_p99_ms"], 1)}
        check(np.array_equal(status, g_status),
              f"[{tag}] status equals the JAX golden on every request "
              f"({int((status == 1).sum())}/{len(status)} solved)")
        check(np.array_equal(iters, golden[f"{config}/iters"]),
              f"[{tag}] iterations equal the JAX golden on every request")
        check(bool(np.isfinite(x).all()) and x.shape == (len(g_status), n)
              and float(dx.max()) <= W_ATOL,
              f"[{tag}] x finite, shape {x.shape}, max|dx| "
              f"{float(dx.max()):.3e} <= {W_ATOL:g}")
        check(budget <= eps and box <= eps,
              f"[{tag}] budget and box hold to eps_abs {eps:g}")
        check(launches[tag]["cluster"] > 0 and launches[tag]["stream"] == 0,
              f"[{tag}] launched the cluster form, never the streaming "
              f"one ({launches[tag]})")
        check(devices == [label] and not loop["degraded"]
              and loop["device"] == label
              and snap["device_switches"] == loop["device_switches"] == 0
              and snap["dispatch_failures"] == loop["dispatch_failures"] == 0,
              f"[{tag}] every result on {label}; no breaker trip, no "
              f"failed dispatch")
        check(snap["completed"] == len(res) and all(
            s[k] == 0 for s in (snap, loop)
            for k in ("failed", "expired", "rejected")),
              f"[{tag}] every future resolved; none failed, expired or "
              f"shed")
        check(report["errors"] == 0 and report["dropped_arrivals"] == 0
              and report["solved"] == int((g_status == 1).sum()),
              f"[{tag}] closed loop: {report['solved']} solved, "
              f"{report['errors']} errors")
        check(snap["compiles"] == n_prewarm == len(slot_ladder(256))
              and report["prewarm_compiles"] == 0
              and report["recompiles_after_warmup"] == 0 and post == 0,
              f"[{tag}] compiles {snap['compiles']} == prewarm's "
              f"{n_prewarm}; {post} after warmup")

    added = []
    for key, rname, base, tag in (
            ("serve_k2", "admm_segment[triangular]_cluster, serve",
             ("trinv", "cluster"), "serve_trinv"),
            ("serve_k1", "admm_segment_factored_cluster[refine=0], serve",
             ("woodbury", "cluster"), "serve_woodbury")):
        params, reqs = calls[tag]
        fn, args, kw = serve_kernel_call(reqs[:256], params, dev)
        kernel_row(rows, key, rname, base, fn, args, kw,
                   launches[tag]["cluster"])
        added.append(key)
    print(f"serve_continuous launched {launches['serve_continuous']} "
          f"(one per segment of the cohort)", flush=True)
    return added, bursts


def te_band(x, iters, g_te, te64, Xs, ys):
    """Per date, the in-sample TE of ``x`` within the band of the f64
    run's (the rule at SECONDARY_PATH); returns (passed, per-date
    distance, band)."""
    import numpy as np

    d_card = np.abs(in_sample_te(Xs, ys, x) - te64)
    floor = ULPS_PER_ITER * int(iters.max()) * F32_EPS * float(te64.max())
    band = KERNEL_VS_PLAIN * float(np.abs(g_te - te64).max()) + floor
    return bool(np.isfinite(x).all() and (d_card <= band).all()), d_card, band


def secondary_phase(rows, reset_counts, device="cuda"):
    """Phase 8: bench.py's secondary configurations on the card against
    the JAX golden (``porqua_tpu_torch/testdata/secondary_golden.npz``);
    returns the kernel rows it adds to ``rows``.

    8a. Compaction on the headline batch (252 dates x 500 assets, f32,
    eps 1e-5): ``compact_woodbury`` (the factored kernel at refine 0),
    ``compact_trinv`` (the triangular-inverse kernel) and
    ``compact_napg`` (NAPG, the plain path), each the fused
    ``solve_qp_batch`` (OFF) and ``CompactingDriver`` (prewarm, one
    warm-up solve, the measured solve: ON). Checks, by the rules at
    SECONDARY_PATH: every date's TE within the band of the f64 run's
    (dates out of order must fail it), |dw| where it is held, every date
    SOLVED or MAX_ITER and SOLVED wherever the golden solved every date,
    the median TE; ON against OFF; no compile inside the measured solve;
    the kernel configs launch their cluster form once per segment at
    two widths or more and never the streaming form, NAPG no kernel; the
    compaction accounting equal to the golden's where every iteration
    count is. Each kernel is held against its plain twin at a narrow
    rung.
    8b. The backends' A/B on the same batch: PDHG (8,000 iterations)
    beside 8a's NAPG and ADMM (trinv) fused runs: status equal to the
    golden on every date, each alternate backend's median TE within
    BACKEND_BAND of the ADMM arm's, PDHG's within PDHG_TE_RTOL of the
    golden's.
    8c. The 5,000-asset north star (one 504 x 5,000 window): the dense
    arm and the sketch-fed arms (sketch_dim 256) on admm, pdhg and napg
    fed the golden's JAX draws: status equal; iterations equal to the
    golden's f32 run (then TE within TE_RTOL) or to its f64 run (then
    weights and TE by the twin rule against the f64 run; another arm's
    weights must fail it); gram_rel_err with the golden's probes within
    TE_RTOL relative. Then the port's own seeded draws: solved, the same
    bits on a second call. At 2,048 x 504: sketch_dim=0 and the sketch
    path's passthrough bit-exact against the plain tracking_step.
    8c'. The dense and admm arms (woodbury at k = 504 and at the
    sketch's k = 256, refine 0) with the golden's params and
    ``backend="pallas"``: held by 8c's rules, each launching the
    factored device-memory form (and no other form) at B = 1; its kernel
    call held against its twin.
    8e. ``rung_solves``: the dense streaming form, C in device memory,
    on the (1024, 128) rung.
    8d. One profiled compacted ``compact_woodbury`` solve."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.compaction import CompactingDriver
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp.admm import segment_kernel_call
    from porqua_tpu_torch.qp.canonical import SketchDraws
    from porqua_tpu_torch.qp.sketch import (SketchParams,
                                            sketched_tracking_qp,
                                            tracking_step_sketched)
    from porqua_tpu_torch.qp.solve import prepare_batch
    from porqua_tpu_torch.synthetic import large_universe_np

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, SECONDARY_PATH))
    meta = json.loads(str(golden["meta"]))
    dev = torch.device(device)
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment
    kernel_of = {"compact_woodbury": K1, "compact_trinv": K2}

    def params(name):
        p = json.loads(str(golden[f"{name}/params"]))
        if name in kernel_of:
            p["backend"] = "pallas"
        return pt.SolverParams(**p)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def counts():
        c = {name: {"cluster": f.cluster_launches,
                    "stream": f.stream_launches,
                    "widths": dict(sorted(f.widths.items()))}
             for name, f in (("K1", K1), ("K2", K2))}
        c["K1"]["global"] = K1.global_launches
        c["K2"]["tail"] = K2.tail_launches
        return c

    def host(sol):
        return {k: getattr(sol, k).cpu().numpy()
                for k in ("x", "status", "iters")}

    Xs_np, ys_np = pt.synthetic_universe_np(
        meta["seed"], meta["n_dates"], meta["window"], meta["n_assets"])
    pt.qp.canonical.HP.apply()
    qps = pt.build_tracking_qp(torch.as_tensor(Xs_np, device=dev),
                               torch.as_tensor(ys_np, device=dev))
    B, n = qps.q.shape
    m, k = qps.l.shape[-1], qps.Pf.shape[-2]
    te_of = lambda x: in_sample_te(Xs_np, ys_np, x)
    med = lambda v: float(np.median(v))

    # -- 8a. compaction ---------------------------------------------------
    added, fused, driver_wb = [], {}, None
    for name in ("compact_woodbury", "compact_trinv", "compact_napg"):
        prm = params(name)
        ci = prm.check_interval
        g = {key: golden[f"{name}/{key}"] for key in
             ("x", "status", "iters", "tracking_error", "x_f64")}
        off = None
        for _ in range(2):        # the first run includes the warm-up
            reset_counts()
            off, off_ms = synced(lambda: pt.solve_qp_batch(qps, prm))
            off_counts = counts()
        off_np = host(off)
        fused[name] = off_np

        driver = CompactingDriver(prm)
        t0 = time.perf_counter()
        n_warm = driver.prewarm(B, n, m, dtype=qps.q.dtype, factor_rows=k)
        prewarm_s = time.perf_counter() - t0
        driver.solve(qps)
        reset_counts()
        (on, rep), on_ms = synced(lambda: driver.solve(qps))
        on_counts = counts()
        on_np = host(on)
        if name == "compact_woodbury":
            driver_wb = driver

        # ON against OFF.
        segs = np.maximum(off_np["iters"] // ci, 1)
        widest = np.array([min(rep.dispatch_sizes[:j]) for j in segs])
        first = segs == 1
        wide = widest >= ON_OFF_WIDTH
        bits = np.all(on_np["x"] == off_np["x"], axis=1) & (
            on_np["iters"] == off_np["iters"])
        same_it = on_np["iters"] == off_np["iters"]
        dx_same = (float(np.abs(on_np["x"] - off_np["x"])[same_it].max())
                   if same_it.any() else 0.0)
        te_on, te_off = te_of(on_np["x"]), te_of(off_np["x"])
        # Against the golden.
        te64 = te_of(g["x_f64"])
        ok_band, d_te, band = te_band(on_np["x"], on_np["iters"],
                                      g["tracking_error"], te64, Xs_np,
                                      ys_np)
        ok_ctl = te_band(np.roll(on_np["x"], 1, axis=0), on_np["iters"],
                         g["tracking_error"], te64, Xs_np, ys_np)[0]
        at_check = ((on_np["status"] == g["status"])
                    & (on_np["iters"] == g["iters"]) & (g["status"] == 1))
        dw = np.abs(on_np["x"] - g["x"]).max(axis=1)
        dw_at = float(dw[at_check].max()) if at_check.any() else 0.0
        hold_dw = float(np.abs(g["x"] - g["x_f64"]).max()) <= W_ATOL
        te_rel = abs(med(te_on) - med(g["tracking_error"])) / med(
            g["tracking_error"])
        te_lim = max(TE_RTOL * med(g["tracking_error"]), KERNEL_VS_PLAIN
                     * abs(med(g["tracking_error"]) - med(te64)))
        g_rep = {key: int(golden[f"{name}/report/{key}"]) for key in
                 ("segments", "lane_segments", "dense_lane_segments",
                  "useful_lane_segments", "max_iter_lanes")}
        g_sizes = tuple(golden[f"{name}/report/dispatch_sizes"].tolist())
        rep_d = {key: getattr(rep, key) for key in g_rep}
        st_counts = lambda s: {label: int((s == code).sum()) for code, label
                               in ((1, "solved"), (2, "max_iter"))}
        print(f"compaction [{name}]: B={B} n={n} m={m} k={k}; OFF "
              f"{off_ms:.1f} ms (launches {off_counts}); ON {on_ms:.1f} ms "
              f"(prewarm {n_warm} entries in {prewarm_s:.2f} s; launches "
              f"{on_counts}); lane-segments OFF {rep.dense_lane_segments} "
              f"-> ON {rep.lane_segments} (reduction "
              f"{rep.savings_vs_dense:.4f}; golden {g_rep['dense_lane_segments']}"
              f" -> {g_rep['lane_segments']}); segments {rep.segments} "
              f"(golden {g_rep['segments']}); dispatch sizes "
              f"{rep.dispatch_sizes} (golden {g_sizes}); compiles in the "
              f"measured solve {rep.compiles}; stage seconds "
              f"{rep.profile['stage_seconds']}", flush=True)
        print(f"compaction [{name}]: status ON {st_counts(on_np['status'])}"
              f", golden {st_counts(g['status'])}; iterations equal to the "
              f"golden on {int((on_np['iters'] == g['iters']).sum())}/{B} "
              f"dates (ON), {int((off_np['iters'] == g['iters']).sum())}/{B}"
              f" (OFF); ON vs OFF: {int(bits.sum())}/{B} dates bit-identical"
              f" ({int(first.sum())} retire at the first boundary, "
              f"{int(wide.sum())} are stepped only at widths >= "
              f"{ON_OFF_WIDTH}), status equal on "
              f"{int((on_np['status'] == off_np['status']).sum())}/{B}, "
              f"iterations on {int(same_it.sum())}/{B}, max|dx| where the "
              f"iterations are equal {dx_same:.3e}; median TE ON "
              f"{med(te_on):.9e} OFF {med(te_off):.9e} golden "
              f"{med(g['tracking_error']):.9e} f64 {med(te64):.9e}",
              flush=True)
        print(f"compaction [{name}]: against the golden: TE to the f64 run "
              f"max {float(d_te.max()):.3e} <= band {band:.3e}; {int(at_check.sum())}"
              f" dates SOLVED at the golden's check, max|dw| {dw_at:.3e} "
              f"({'held' if hold_dw else 'printed'}; all dates "
              f"{float(dw.max()):.3e}; golden to its f64 run "
              f"{float(np.abs(g['x'] - g['x_f64']).max()):.3e}); median TE "
              f"rel {te_rel:.3e}", flush=True)
        check(ok_band, f"[{name}] every date's TE within the band of the "
              f"f64 run's ({float(d_te.max()):.3e} <= {band:.3e})")
        check(not ok_ctl, f"[{name}] control: the dates out of order fail "
              f"the TE band")
        if hold_dw:
            check(dw_at <= W_ATOL, f"[{name}] max|dw| {dw_at:.3e} <= "
                  f"{W_ATOL:g} on the dates at the golden's check")
        all_solved = bool((g["status"] == 1).all())
        check(bool(np.isin(on_np["status"], (1, 2)).all()) and (
            not all_solved or bool((on_np["status"] == 1).all())),
            f"[{name}] every date SOLVED or MAX_ITER"
            + (", SOLVED on every date as in the golden" if all_solved
               else ""))
        check(abs(med(te_on) - med(g["tracking_error"])) <= te_lim,
              f"[{name}] median TE within {te_lim / med(g['tracking_error']):.3g}"
              f" relative of the golden's ({te_rel:.3e})")
        check(bool(bits[wide].all()),
              f"[{name}] ON vs OFF: the {int(wide.sum())} dates stepped only"
              f" at widths >= {ON_OFF_WIDTH} bit-identical (the "
              f"{int(first.sum())} first-boundary ones among them)")
        check(abs(med(te_on) - med(te_off)) <= TE_DRIFT,
              f"[{name}] median TE drift ON vs OFF "
              f"{abs(med(te_on) - med(te_off)):.3e} <= {TE_DRIFT:g}")
        check(rep.compiles == 0, f"[{name}] no compile inside the measured "
              f"solve")
        if np.array_equal(on_np["iters"], g["iters"]):
            check(rep_d == g_rep and tuple(rep.dispatch_sizes) == g_sizes,
                  f"[{name}] compaction accounting equals the golden's")
        wrapper = kernel_of.get(name)
        if wrapper is None:
            check(all(c["cluster"] == c["stream"] == 0 for c in
                      (off_counts["K1"], off_counts["K2"], on_counts["K1"],
                       on_counts["K2"])),
                  f"[{name}] the plain path launched no kernel")
            continue
        tag = "K1" if wrapper is K1 else "K2"
        c_on, c_off = on_counts[tag], off_counts[tag]
        check(c_off["cluster"] > 0 and c_off["stream"] == 0
              and list(c_off["widths"]) == [B],
              f"[{name}] OFF launched the cluster form at width {B} only")
        check(c_on["cluster"] == rep.segments and c_on["stream"] == 0
              and len(c_on["widths"]) >= 2,
              f"[{name}] ON launched the cluster form once per segment at "
              f"{len(c_on['widths'])} widths, never the streaming form")
        # The kernel against its plain twin at a narrow rung.
        w = min([s for s in rep.dispatch_sizes if s < B] + [128])
        sub = type(qps)(*(None if f is None else f[:w] for f in qps))
        scaled, _, carry, _, _ = prepare_batch(sub, prm)
        fn, args, kw = segment_kernel_call(carry, scaled, prm)
        key = f"compact_{tag.lower()}"
        base = (("woodbury", "cluster") if tag == "K1"
                else ("trinv", "cluster"))
        rname = (f"admm_segment_factored_cluster[refine=0], compact w={w}"
                 if tag == "K1" else
                 f"admm_segment[triangular]_cluster, compact w={w}")
        kernel_row(rows, key, rname, base, fn, args, kw, c_on["cluster"])
        added.append(key)

    # -- 8b. the backends' A/B ---------------------------------------------
    prm = params("pdhg")
    pdhg, pdhg_ms = synced(lambda: pt.solve_qp_batch(qps, prm))
    pd = host(pdhg)
    te = {"admm": med(te_of(fused["compact_trinv"]["x"])),
          "napg": med(te_of(fused["compact_napg"]["x"])),
          "pdhg": med(te_of(pd["x"]))}
    drift = {b: abs(te[b] - te["admm"]) / te["admm"] for b in ("pdhg",
                                                               "napg")}
    g_te = med(golden["pdhg/tracking_error"])
    pd_rel = abs(te["pdhg"] - g_te) / g_te
    for b, res in (("admm", fused["compact_trinv"]),
                   ("napg", fused["compact_napg"]), ("pdhg", pd)):
        it = res["iters"]
        print(f"backends [{b}]: iters p50 {np.percentile(it, 50):.0f} p95 "
              f"{np.percentile(it, 95):.0f} max {int(it.max())}; status "
              f"{ {int(s): int((res['status'] == s).sum()) for s in np.unique(res['status'])} }"
              f"; median TE {te[b]:.9e}", flush=True)
    print(f"backends: PDHG {pdhg_ms:.1f} ms for {prm.max_iter} iterations; "
          f"pdhg_te_rel_drift {drift['pdhg']:.4e} (golden "
          f"{abs(g_te - med(golden['compact_trinv/tracking_error'])) / med(golden['compact_trinv/tracking_error']):.4e})"
          f", napg_te_rel_drift {drift['napg']:.4e}; PDHG median TE "
          f"against the golden's {pd_rel:.3e}; the ADMM arm's against it "
          f"{abs(te['admm'] - g_te) / g_te:.3e}", flush=True)
    check(np.array_equal(pd["status"], golden["pdhg/status"])
          and np.array_equal(pd["iters"], golden["pdhg/iters"]),
          f"[pdhg] status and iterations equal the golden on every date "
          f"({int((pd['status'] == 1).sum())}/{B} solved)")
    check(drift["pdhg"] <= BACKEND_BAND and drift["napg"] <= BACKEND_BAND,
          f"[backends] pdhg/napg median TE within {BACKEND_BAND:g} of the "
          f"ADMM arm's")
    check(pd_rel <= PDHG_TE_RTOL, f"[pdhg] median TE within "
          f"{PDHG_TE_RTOL:g} relative of the golden's ({pd_rel:.3e})")
    check(abs(te["admm"] - g_te) / g_te > PDHG_TE_RTOL,
          "[pdhg] control: the ADMM arm's median TE fails that limit")

    # -- 8c. the 5,000-asset north star ------------------------------------
    X5, y5 = large_universe_np(meta["sk_seed"], meta["sk_window"],
                               meta["sk_assets"])
    draws = SketchDraws(*(torch.as_tensor(golden[f"northstar/{key}"])
                          for key in ("bucket", "sign", "probes")))
    arms, te5 = {}, {}

    def northstar_checks(arm, label, res, ms):
        """The arm's rules (the docstring's 8c) on ``res``; returns its
        TE."""
        gk = lambda key: golden[f"northstar/{arm}/{key}"]
        st, it = int(res.status[0]), int(res.iters[0])
        w = res.weights.cpu().numpy()
        te = float(res.tracking_error[0])
        at_f32 = it == int(gk("iters")[0])
        d_card = float(np.abs(w - gk("weights_f64")).max())
        d_gold = float(np.abs(gk("weights") - gk("weights_f64")).max())
        t_card = abs(te - float(gk("tracking_error_f64")[0]))
        t_gold = abs(float(gk("tracking_error")[0])
                     - float(gk("tracking_error_f64")[0]))
        floor = ULPS_PER_ITER * it * F32_EPS * float(np.abs(w).max())
        te_rel = abs(te / float(gk("tracking_error")[0]) - 1)
        print(f"northstar [{label}]: {ms:.1f} ms; status {st} (golden "
              f"{int(gk('status')[0])}), iters {it} (golden "
              f"{int(gk('iters')[0])}, its f64 run {int(gk('iters_f64')[0])}"
              f"); TE {te:.9e} (golden "
              f"{float(gk('tracking_error')[0]):.9e}, rel {te_rel:.3e}; f64 "
              f"{float(gk('tracking_error_f64')[0]):.9e}); weights to the f64"
              f" run {d_card:.3e} (golden's {d_gold:.3e})", flush=True)
        check(st == int(gk("status")[0]) == 1,
              f"[northstar {label}] SOLVED as in the golden")
        if at_f32:
            check(te_rel <= TE_RTOL, f"[northstar {label}] iterations equal "
                  f"the golden's; TE within {TE_RTOL:g} relative")
        else:
            dense_w = arms["dense"].weights.cpu().numpy()
            ctl = float(np.abs(dense_w - gk("weights_f64")).max())
            check(it == int(gk("iters_f64")[0])
                  and d_card <= KERNEL_VS_PLAIN * d_gold + floor
                  and t_card <= KERNEL_VS_PLAIN * t_gold,
                  f"[northstar {label}] crosses eps at the f64 run's check "
                  f"({it}); weights {d_card:.3e} <= {KERNEL_VS_PLAIN:g} x "
                  f"{d_gold:.3e} + {floor:.2g} and TE {t_card:.3e} <= "
                  f"{KERNEL_VS_PLAIN:g} x {t_gold:.3e} from the f64 run")
            check(ctl > KERNEL_VS_PLAIN * d_gold + floor,
                  f"[northstar {label}] control: the dense arm's weights "
                  f"fail that rule ({ctl:.3e})")
        return te

    for arm in ("dense", "admm", "pdhg", "napg"):
        prm = pt.SolverParams(**json.loads(str(
            golden[f"northstar/{arm}/params"])))
        for _ in range(2):
            res, ms = synced(lambda: pt.tracking_step(X5, y5, prm,
                                                      draws=draws))
        arms[arm] = res
        te5[arm] = northstar_checks(arm, arm, res, ms)
    drift5 = {a: abs(te5[a] - te5["dense"]) / te5["dense"]
              for a in ("admm", "pdhg", "napg")}
    g_dense = float(golden["northstar/dense/tracking_error"][0])
    g_drift = max(abs(float(golden[f"northstar/{a}/tracking_error"][0])
                      - g_dense) / g_dense for a in ("admm", "pdhg", "napg"))
    X5d, y5d = (torch.as_tensor(X5, device=dev),
                torch.as_tensor(y5, device=dev))
    _, info = sketched_tracking_qp(X5d, y5d, SketchParams(
        meta["sk_dim"], meta["sketch_seed"], meta["probes"]), draws=draws)
    gre, g_gre = float(info.gram_rel_err[0]), float(
        golden["northstar/gram_rel_err"])
    print(f"northstar: te_rel_drift {drift5} (max {max(drift5.values()):.4f};"
          f" golden's {g_drift:.4f}); gram_rel_err {gre:.6f} (golden "
          f"{g_gre:.6f})", flush=True)
    check(abs(gre - g_gre) <= TE_RTOL * g_gre,
          f"[northstar] gram_rel_err within {TE_RTOL:g} relative of the "
          f"golden's")
    own = dataclasses.replace(
        pt.SolverParams(**json.loads(str(golden["northstar/dense/params"]))),
        sketch_dim=meta["sk_dim"], sketch_seed=meta["sketch_seed"])
    r1, own_ms = synced(lambda: pt.tracking_step(X5, y5, own))
    r2 = pt.tracking_step(X5, y5, own)
    _, own_info = sketched_tracking_qp(X5d, y5d, SketchParams(
        meta["sk_dim"], meta["sketch_seed"], meta["probes"]))
    print(f"northstar [own draws, seed {meta['sketch_seed']}]: {own_ms:.1f} "
          f"ms; status {int(r1.status[0])}, iters {int(r1.iters[0])}, TE "
          f"{float(r1.tracking_error[0]):.9e} (drift "
          f"{abs(float(r1.tracking_error[0]) - te5['dense']) / te5['dense']:.4f}"
          f"); gram_rel_err {float(own_info.gram_rel_err[0]):.6f}",
          flush=True)
    check(int(r1.status[0]) == 1 and all(torch.equal(a, b) for a, b in
                                         zip(r1, r2)),
          "[northstar own draws] SOLVED, the same bits on a second call")
    X2, y2 = large_universe_np(meta["sk_seed"], meta["sk_window"], 2048)
    p2 = pt.SolverParams(max_iter=500, eps_abs=1e-3, eps_rel=1e-3,
                         polish=False)
    plain = pt.tracking_step(X2, y2, p2)
    off0 = pt.tracking_step(X2, y2, dataclasses.replace(p2, sketch_dim=0))
    off1, _ = tracking_step_sketched(X2, y2, p2, SketchParams())
    on2, info2 = tracking_step_sketched(X2, y2, p2, SketchParams(
        meta["sk_dim"], meta["sketch_seed"]))
    te_off = float(plain.tracking_error[0])
    print(f"sketch at 2048 x {meta['sk_window']}: TE off {te_off:.9e}, on "
          f"{float(on2.tracking_error[0]):.9e} (rel drift "
          f"{abs(float(on2.tracking_error[0]) - te_off) / te_off:.4f}), "
          f"gram_rel_err {float(info2.gram_rel_err[0]):.6f}, solved "
          f"{int(plain.status[0]) == 1}/{int(on2.status[0]) == 1}",
          flush=True)
    check(all(torch.equal(a, b) for r in (off0, off1)
              for a, b in zip(r, plain)),
          "[sketch 2048] sketch_dim=0 and SketchParams() bit-exact against "
          "the plain tracking_step")

    # -- 8c'. the two woodbury arms through the kernel ---------------------
    for arm in ("dense", "admm"):
        prm = dataclasses.replace(pt.SolverParams(**json.loads(str(
            golden[f"northstar/{arm}/params"]))), backend="pallas")
        for _ in range(2):        # the first run includes the warm-up
            reset_counts()
            res, ms = synced(lambda: pt.tracking_step(X5, y5, prm,
                                                      draws=draws))
            c = counts()
        print(f"northstar [{arm} pallas]: launches {c}", flush=True)
        northstar_checks(arm, f"{arm} pallas", res, ms)
        check(c["K1"]["global"] > 0 and c["K1"]["cluster"] == 0
              and c["K1"]["stream"] == 0
              and not any(c["K2"][f] for f in ("cluster", "tail", "stream")),
              f"[northstar {arm} pallas] launched the factored device-memory"
              f" form ({c['K1']['global']}) and no other form")
        # Its kernel call, from the first segment, against the twin.
        qp5 = pt.build_tracking_qp(X5d, y5d, sketch_dim=prm.sketch_dim,
                                   sketch_seed=prm.sketch_seed, draws=draws)
        scaled, _, carry, _, _ = prepare_batch(qp5, prm)
        fn, args, kw = segment_kernel_call(carry, scaled, prm)
        n5, k5 = args[0].shape[-1], args[0].shape[-2]
        check(fn is K1 and admm_kernel.factored_form(
            n5, args[6].shape[-2], k5, kw["refine_steps"]) == "global",
              f"[northstar {arm} pallas] its kernel call goes to the "
              f"device-memory form")
        key = f"northstar_{arm}_k1"
        kernel_row(rows, key, f"admm_segment_factored_global[refine="
                   f"{kw['refine_steps']}], northstar {arm} k={k5}",
                   ("woodbury", "cluster"), fn, args, kw, c["K1"]["global"])
        added.append(key)

    # -- 8e. the (1024, 128) rung through the dense streaming form -------
    added += rung_solves(rows, reset_counts, counts, synced, device)

    # -- 8d. where the time goes -------------------------------------------
    profile_run(lambda: driver_wb.solve(qps),
                "profile [compact_woodbury, compacted]")
    return added


# Phase 8e: RUNG_PROBLEMS tracking problems of RUNG_ASSETS assets
# (seeded) with RUNG_ROWS - 1 seeded rows drawn uniformly from [-1, 1]
# beside the budget row, each held within +-RUNG_BOUND (so that 43 to
# 69 of the 100 bind at the optimum), padded to the service's
# (1024, 128) ladder rung and solved at eps RUNG_EPS: 50 to 100
# iterations, two to four segments chained through the kernel. The
# window (five years of days) is longer than the universe, so each
# optimum is a point; with a year's window it is a face (ROADMAP §C).
RUNG_PROBLEMS, RUNG_ASSETS, RUNG_ROWS, RUNG = 8, 1000, 101, (1024, 128)
RUNG_WINDOW, RUNG_EPS, RUNG_BOUND, RUNG_SEED = 1260, 1e-4, 0.02, 15
# The form each kind takes at the rung: L^-1 on a 16-block cluster,
# K^-1 on one with a streamed tail.
RUNG_FORM = {"trinv": "cluster", "inverse": "tail"}


def rung_problems(dtype, device):
    """The batch of phase 8e in torch ``dtype`` on ``device``: each
    problem built by ``build_tracking_qp``, the rows added, then padded
    to RUNG. Returns the batch and the rows (numpy)."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.qp.canonical import pad_qp

    Xs, ys = pt.synthetic_universe_np(RUNG_SEED, RUNG_PROBLEMS, RUNG_WINDOW,
                                      RUNG_ASSETS)
    rows = np.random.default_rng(RUNG_SEED).uniform(
        -1.0, 1.0, (RUNG_PROBLEMS, RUNG_ROWS - 1, RUNG_ASSETS))
    on = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    qp = pt.build_tracking_qp(on(Xs), on(ys))
    bound = torch.full((RUNG_PROBLEMS, RUNG_ROWS - 1), RUNG_BOUND,
                       dtype=dtype, device=device)
    qp = qp._replace(
        C=torch.cat([qp.C, on(rows)], dim=-2),
        l=torch.cat([qp.l, -bound], dim=-1),
        u=torch.cat([qp.u, bound], dim=-1),
        row_mask=torch.ones((RUNG_PROBLEMS, RUNG_ROWS),
                            dtype=qp.row_mask.dtype, device=device))
    lanes = [pad_qp(type(qp)(*(None if f is None else f[i] for f in qp)),
                    *RUNG) for i in range(RUNG_PROBLEMS)]
    return type(qp)(*(None if f[0] is None else torch.stack(f)
                      for f in zip(*lanes))), rows


def rung_solves(rows, reset_counts, counts, synced, device="cuda"):
    """Phase 8e: ``solve_qp_batch`` with ``backend="pallas"`` on
    rung_problems at the (1024, 128) rung, once with ``linsolve="trinv"``
    and once with ``"inverse"``: each must launch the form RUNG_FORM
    names (L^-1 on a 16-block cluster, K^-1 on one with a streamed
    tail) in two or more chained segments, and no other form (the
    one-block streaming form is timed beside it on the same kernel call
    as the yardstick), and end in the plain path's (``backend="xla"``) status
    on every problem, with rows binding on every problem. Its weights
    are held by the twin rule at the iteration each problem stopped at:
    the plain path run with no tolerance for exactly that many
    iterations in f64 gives the reference, and in f32 the noise, the
    largest distance to f64 over four summation orders (the batch on
    the card, on the CPU, the lanes reversed, and the kernel's plain
    twin on the CPU: ``backend="pallas"`` on CPU tensors), as
    ``twin_reference`` takes it for a kernel call. (A problem that
    crosses eps one check later than another run ends elsewhere, and
    that is not rounding.) Each kernel call is held against its twin.
    Returns the kernel rows it adds."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp.admm import segment_kernel_call
    from porqua_tpu_torch.qp.solve import prepare_batch

    added = []
    qp32, C_rows = rung_problems(torch.float32, device)
    qp64 = rung_problems(torch.float64, device)[0]
    w = lambda x: x[:, :RUNG_ASSETS].cpu().numpy()
    rev = np.arange(RUNG_PROBLEMS)[::-1].copy()
    pick = lambda qp, idx, dev: type(qp)(*(
        None if f is None else f[torch.as_tensor(idx, device=f.device)].to(dev)
        for f in qp))
    qp_cpu = pick(qp32, np.arange(RUNG_PROBLEMS), "cpu")
    # summation order -> (batch, device, lane order, backend)
    orders = {"card": (qp32, device, None, "xla"),
              "cpu": (qp_cpu, "cpu", None, "xla"),
              "reversed": (pick(qp32, rev, device), device, rev, "xla"),
              "twin": (qp_cpu, "cpu", None, "pallas")}
    for kind in ("trinv", "inverse"):
        prm = pt.SolverParams(linsolve=kind, backend="pallas",
                              eps_abs=RUNG_EPS, eps_rel=RUNG_EPS,
                              polish=False, max_iter=4000)
        plain = dataclasses.replace(prm, backend="xla")
        for _ in range(2):        # the first run includes the warm-up
            reset_counts()
            sol, ms = synced(lambda: pt.solve_qp_batch(qp32, prm))
            c = counts()
        sol32, plain_ms = synced(lambda: pt.solve_qp_batch(qp32, plain))
        status, iters = sol.status.cpu().numpy(), sol.iters.cpu().numpy()
        # The plain path for exactly each stopping count: in f64, and in
        # f32 in each summation order.
        at64 = np.zeros((RUNG_PROBLEMS, RUNG_ASSETS))
        at32 = {name: np.zeros_like(at64) for name in orders}
        for t in sorted(set(iters.tolist())):
            fixed = dataclasses.replace(plain, eps_abs=0.0, eps_rel=0.0,
                                        max_iter=int(t))
            lanes = iters == t
            at64[lanes] = w(pt.solve_qp_batch(qp64, fixed).x)[lanes]
            for name, (qp, dev, order, backend) in orders.items():
                x = w(pt.solve_qp_batch(
                    qp, dataclasses.replace(fixed, backend=backend),
                    device=dev).x)
                at32[name][lanes] = (x if order is None
                                     else x[np.argsort(order)])[lanes]
        dist = {name: np.abs(a - at64).max(axis=1)
                for name, a in at32.items()}
        noisiest = np.stack([at32[name] for name in orders])[
            np.argmax(np.stack([dist[name] for name in orders]), axis=0),
            np.arange(RUNG_PROBLEMS)]
        ok, d_card, band = twin_rule(w(sol.x), noisiest, at64)
        binding = (np.abs(np.einsum("prn,pn->pr", C_rows, at64))
                   >= RUNG_BOUND * (1 - 1e-3)).sum(axis=1)
        print(f"rung {kind} {RUNG}: B={RUNG_PROBLEMS}, {RUNG_ASSETS} assets, "
              f"{RUNG_ROWS} rows (binding {binding.tolist()}), eps "
              f"{RUNG_EPS:g}; {ms:.1f} ms (plain path {plain_ms:.1f} ms); "
              f"launches {c}; status {status.tolist()} (plain "
              f"{sol32.status.tolist()}); iters {iters.tolist()} (plain "
              f"{sol32.iters.tolist()}); weights at the same iteration: "
              f"to the f64 run {np.array2string(d_card, precision=3)}, "
              f"band {np.array2string(band, precision=3)}; f32 plain to "
              f"f64 by order: " + "; ".join(
                  f"{name} {np.array2string(d, precision=3)}"
                  for name, d in dist.items()), flush=True)
        form = admm_kernel.dense_form(*RUNG, kind == "trinv")
        others = [f for f in ("cluster", "tail", "stream") if f != form]
        check(c["K2"][form] >= 2 and not any(c["K2"][f] for f in others)
              and not any(c["K1"][f] for f in ("cluster", "stream", "global")),
              f"[rung {kind}] chained {c['K2'][form]} launches of the dense "
              f"{form} form (two or more) and no other form")
        check(np.array_equal(status, sol32.status.cpu().numpy()),
              f"[rung {kind}] status equals the plain path's on every "
              f"problem")
        check(bool((binding > 0).all()), f"[rung {kind}] rows bind on every "
              f"problem")
        check(bool(ok.all()), f"[rung {kind}] weights within the twin rule "
              f"of the f64 run at the same iteration on every problem")
        scaled, _, carry, _, _ = prepare_batch(qp32, prm)
        fn, args, kw = segment_kernel_call(carry, scaled, prm)
        check(fn is admm_kernel.admm_segment
              and form == RUNG_FORM[kind],
              f"[rung {kind}] its kernel call goes to the {RUNG_FORM[kind]} "
              f"form (the router picks {form})")
        family = "triangular" if kind == "trinv" else "inverse"
        # The form the rung runs, and the one-block form beside it on the
        # same call as the yardstick (no launch on the path).
        for shown, launched in ((form, c["K2"][form]), ("stream", 0)):
            key = f"rung_{kind}" if shown == form else f"rung_{kind}_stream"
            kernel_row(rows, key, f"admm_segment[{family}]_{shown}, rung "
                       f"{RUNG[0]}x{RUNG[1]} B={RUNG_PROBLEMS}",
                       (kind, "cluster" if shown != "stream" else "stream"),
                       fn, args, kw, launched, form=shown)
            added.append(key)
    return added


def twin_rule(card, g32, g64, pooled=None, floor=None):
    """Per row (a date) the twin rule of DIFF_PATH over the last axis:
    returns (passed per row, the card's distance to f64, the band).
    ``pooled`` (a row mask) takes XLA-CPU's f32 distance as its largest
    over those rows, the configuration's f32 floor, for every row.
    ``floor`` replaces the band's GRAD_ULPS ulps of each row's scale."""
    import numpy as np

    card, g32, g64 = (np.asarray(a, np.float64).reshape(len(a), -1)
                      for a in (card, g32, g64))
    d_card = np.abs(card - g64).max(axis=1)
    d_twin = np.abs(g32 - g64).max(axis=1)
    if pooled is not None:
        d_twin = np.full_like(d_twin, d_twin[pooled].max(initial=0.0))
    band = KERNEL_VS_PLAIN * d_twin + (
        GRAD_ULPS * F32_EPS * np.abs(g64).max(axis=1) if floor is None
        else floor)
    return np.isfinite(card).all(axis=1) & (d_card <= band), d_card, band


def chain_market(Xo):
    """The chain's held-period series: the dates' evaluation windows end
    to end, (dates * oos, n), rebalanced at 0, oos, 2 oos, ..."""
    import numpy as np

    d, oos, n = Xo.shape
    return Xo.reshape(d * oos, n), np.arange(d) * oos


def net_sharpe(ret, valid):
    """Annualized net Sharpe of the valid daily returns."""
    nv = valid.sum()
    mean = ret.sum() / nv
    var = (((ret - mean) ** 2) * valid).sum() / (nv - 1.0)
    return mean / var ** 0.5 * 252.0 ** 0.5


def stopwatch(dev):
    """``mark()`` records a point; ``ms()`` the milliseconds between
    consecutive points: CUDA events on the card, the host clock
    elsewhere."""
    import torch

    points = []
    if dev.type == "cuda":
        def mark():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            points.append(e)

        def ms():
            points[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(points, points[1:])]
    else:
        def mark():
            points.append(time.perf_counter())

        def ms():
            return [(b - a) * 1e3 for a, b in zip(points, points[1:])]
    return mark, ms


def diff_phase(rows, reset_counts, device="cuda"):
    """Phase 9: the differentiable solve on the card against the JAX
    golden (``porqua_tpu_torch/testdata/diff_golden.npz``); returns the
    kernel rows it adds to ``rows``. Rules at DIFF_PATH.

    9a. examples/differentiable_tuning.py's objective at the main
    path's width: per date the tracking QP of a 252-day fit window
    (ridge 10**theta, theta one leaf per date) through
    ``solve_qp_batch_diff``, the loss the mean out-of-sample TE over
    the next 21 days; dL/dtheta per date and summed, dL/dy_fit per
    date. ``diff_trinv`` (the triangular-inverse kernel), ``diff_woodbury``
    (the factored kernel at refine 1), both with the factored adjoint
    (k + m = 253 < 500), and ``diff_dense`` (Pf/Pdiag dropped: the dense
    adjoint, the triangular-inverse kernel).
    9b. examples/net_sharpe_tuning.py's chain over the first dates: each
    date ``solve_qp_l1_diff`` at B = 1 (the factored kernel at refine 0
    with the L1 prox) from the last date's solution, the weights through
    ``accounting.simulate`` into net Sharpe, dS/dlog(lambda); then each
    date alone from the golden's carry, its vjp on the golden's incoming
    cotangent.
    9c. The box problem (date 0's first 100 assets, ridge 1e-4, box
    capped at 0.02, so both sides of the box bind; 253 > 100 runs the
    dense adjoint): the TE's gradient w.r.t. q, C, l, u, lb, ub through
    ``solve_qp_diff`` (the triangular-inverse kernel at B = 1); two
    faulty backwards (every box cotangent to lb; the C cotangent
    dropped) must fail its rule.
    9d. ``compare_solvers`` on date 0 as examples/compare_solver.py poses
    it (500 assets, no ridge, box capped at 0.1; default params), the
    f32 row again through the triangular-inverse kernel, SLSQP and the
    IPM on its first 100 assets."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.accounting import simulate
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp import diff
    from porqua_tpu_torch.qp.admm import admm_init, segment_kernel_call
    from porqua_tpu_torch.qp.canonical import CanonicalQP
    from porqua_tpu_torch.qp.solve import _prepare_impl

    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, DIFF_PATH))
    meta = json.loads(str(golden["meta"]))
    dev = torch.device(device)
    f32 = torch.float32
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment
    kernel_of = {"diff_trinv": K2, "diff_woodbury": K1, "diff_dense": K2}

    def params(key):
        p = json.loads(str(golden[f"{key}/params"]))
        p["backend"] = "pallas"
        return pt.SolverParams(**p)

    def counts():
        return {name: {"cluster": f.cluster_launches,
                       "stream": f.stream_launches}
                for name, f in (("K1", K1), ("K2", K2))}

    def on(a, **kw):
        return torch.as_tensor(np.asarray(a), device=dev, **kw)

    def unpack(bits, width):
        return np.unpackbits(bits, axis=-1, count=width).astype(bool)

    Xs, ys = pt.synthetic_universe_np(meta["seed"], meta["n_dates"],
                                      meta["fit"] + meta["oos"],
                                      meta["n_assets"])
    fit = meta["fit"]
    Xf_np, yf_np, Xo_np, yo_np = (Xs[:, :fit], ys[:, :fit], Xs[:, fit:],
                                  ys[:, fit:])
    Xf, yf, Xo, yo = (on(a) for a in (Xf_np, yf_np, Xo_np, yo_np))
    B, n = Xf.shape[0], Xf.shape[-1]
    pt.qp.canonical.HP.apply()
    added = []

    # -- 9a. ridge tuning over the tracking batch ---------------------------
    def tuning(prm, dense):
        theta = torch.full((B,), float(np.log10(meta["ridge"])), dtype=f32,
                           device=dev, requires_grad=True)
        y = yf.clone().requires_grad_(True)
        qp = pt.build_tracking_qp(Xf, y, ridge=10.0 ** theta)
        if dense:
            qp = qp._replace(Pf=None, Pdiag=None)
        mark, ms = stopwatch(dev)
        mark()
        w = diff.solve_qp_batch_diff(qp, prm, device=dev)
        r = torch.einsum("btn,bn->bt", Xo, w) - yo
        loss = torch.sqrt(torch.mean(r * r, dim=-1)).mean()
        mark()
        loss.backward()
        mark()
        return loss.detach(), theta.grad, y.grad, ms()

    for name in ("diff_trinv", "diff_woodbury", "diff_dense"):
        prm = params(name)
        dense = name == "diff_dense"
        tuning(prm, dense)                   # warm-up: builds, first calls
        reset_counts()
        loss, dth, dy, (fwd_ms, bwd_ms) = tuning(prm, dense)
        c = counts()["K1" if kernel_of[name] is K1 else "K2"]
        qp = pt.build_tracking_qp(Xf, yf, ridge=meta["ridge"])
        if dense:
            qp = qp._replace(Pf=None, Pdiag=None)
        sol = pt.solve_qp_batch(qp, prm, device=dev)
        aC, _, aB, _, upC, upB = diff.active_sets(qp, sol)
        status, iters = sol.status.cpu().numpy(), sol.iters.cpu().numpy()
        dth, dy = dth.cpu().numpy(), dy.cpu().numpy()
        g = {k: golden[f"{name}/{k}"] for k in (
            "status", "iters", "iters_f64", "dtheta", "dy", "dtheta_f64",
            "dy_f64")}
        m = aC.shape[-1]
        same = np.ones(B, bool)
        same64 = np.ones(B, bool)
        for key, mask, width in (("aC", aC, m), ("aB", aB, n),
                                 ("upC", upC, m), ("upB", upB, n)):
            card = mask.bool().cpu().numpy()
            g32 = unpack(golden[f"{name}/{key}"], width)
            g64 = unpack(golden[f"{name}/{key}_f64"], width)
            same &= (card == g32).all(axis=1)
            same64 &= (g32 == g64).all(axis=1)
        # A configuration off its f32 floor: XLA-CPU's f32 run stops at
        # its f64 run's check on every date. At the floor (f32 Woodbury
        # at eps 1e-5) a date's stopping check is a draw of the rounding
        # (ROADMAP section C), and a date is held only where it stopped
        # at the golden's check.
        off_floor = bool((g["iters"] == g["iters_f64"]).all())
        g_finite = (np.isfinite(g["dtheta"])
                    & np.isfinite(g["dy"]).all(axis=1))
        held = (same & (status == g["status"]) & (iters == g["iters"])
                & g_finite)
        ok_th, d_th, band_th = twin_rule(dth[:, None], g["dtheta"][:, None],
                                         g["dtheta_f64"][:, None],
                                         pooled=held)
        ok_y, d_y, band_y = twin_rule(dy, g["dy"], g["dy_f64"],
                                      pooled=None if off_floor else held)
        on_dates = (status == g["status"]) & g_finite
        agg = twin_rule(
            [[dth[on_dates].sum()]],
            [[g["dtheta"][on_dates].astype(np.float64).sum()]],
            [[g["dtheta_f64"][on_dates].astype(np.float64).sum()]])
        def ratio(d, b):
            r = np.where(held, d / np.where(b > 0, b, 1.0), 0.0)
            i = int(np.argmax(r)) if r.size else 0
            return f"{float(r.max(initial=0.0)):.3f} (date {i}: {d[i]:.3e}" \
                   f" / {b[i]:.3e})"

        unsolved = status != 1
        zero_card = bool((dth[unsolved] == 0).all()
                         and (dy[unsolved] == 0).all())
        g_unsolved = g["status"] != 1
        zero_gold = bool((g["dtheta"][g_unsolved] == 0).all()
                         and (g["dy"][g_unsolved] == 0).all())
        d64 = np.abs(dth.astype(np.float64) - g["dtheta_f64"])
        print(f"diff [{name}]: B={B} n={n}; forward {fwd_ms:.1f} ms, "
              f"backward {bwd_ms:.1f} ms (CUDA events; {card_line()}); "
              f"launches {c}; solved {int((status == 1).sum())}/{B} (golden "
              f"{int((g['status'] == 1).sum())}), iters "
              f"{sorted(set(iters.tolist()))}; XLA-CPU's f32 run at its f64 "
              f"run's check on {int((g['iters'] == g['iters_f64']).sum())}/"
              f"{B} dates, the card's iterations equal to the golden's on "
              f"{int((iters == g['iters']).sum())}/{B}; loss "
              f"{loss.item():.9e} (golden "
              f"{float(golden[f'{name}/loss']):.9e}, f64 "
              f"{float(golden[f'{name}/loss_f64']):.9e}); active sets equal "
              f"to the golden's on {int(same.sum())}/{B} dates (XLA-CPU f32 "
              f"to its f64 run: {int(same64.sum())}/{B}); XLA-CPU's f32 "
              f"gradient finite on {int(g_finite.sum())}/{B} dates; dL/dtheta "
              f"{float(dth.sum()):.6e} (golden "
              f"{float(np.nansum(g['dtheta'])):.6e}, f64 "
              f"{float(g['dtheta_f64'].sum()):.6e}; over the "
              f"{int(on_dates.sum())} dates of equal status and a finite "
              f"golden: distance {float(agg[1][0]):.3e}, band "
              f"{float(agg[2][0]):.3e}); per date on the {int(held.sum())} "
              f"held dates: dtheta max distance/band {ratio(d_th, band_th)}"
              f", dy {ratio(d_y, band_y)}; dates past the band: dtheta "
              f"{np.flatnonzero(~ok_th & held).tolist()}, dy "
              f"{np.flatnonzero(~ok_y & held).tolist()}; the card's dtheta "
              f"to the f64 run: median {float(np.median(d64)):.3e}, max "
              f"{float(d64.max()):.3e}", flush=True)
        if off_floor:
            check(np.array_equal(status, g["status"])
                  and np.array_equal(iters, g["iters"]),
                  f"[{name}] status and iterations equal the golden on "
                  f"every date")
        else:
            check(bool(np.isin(status, (1, 2)).all()),
                  f"[{name}] at its f32 floor: every date SOLVED or "
                  f"MAX_ITER (status and iterations printed)")
        check(int(same.sum()) >= int(same64.sum()),
              f"[{name}] active sets equal to the golden's on "
              f"{int(same.sum())} dates >= XLA-CPU f32 to f64's "
              f"{int(same64.sum())}")
        check(bool(ok_th[held].all()) and bool(ok_y[held].all()),
              f"[{name}] per-date dL/dtheta and dL/dy_fit within the twin "
              f"band on the {int(held.sum())} dates of equal sets, "
              f"status and iterations with a finite golden")
        check(not on_dates.any() or bool(agg[0][0]),
              f"[{name}] dL/dtheta within the twin band")
        check(bool(np.isfinite(dth).all() and np.isfinite(dy).all()),
              f"[{name}] every gradient finite (a failed adjoint "
              f"factorization ends as zero, never NaN)")
        check(zero_card and zero_gold, f"[{name}] the "
              f"{int(unsolved.sum())} unsolved dates have zero gradient "
              f"(golden: {int(g_unsolved.sum())})")
        check(c["cluster"] > 0 and c["stream"] == 0,
              f"[{name}] launched the cluster form, never the streaming one")
        if not dense:
            scaled = _prepare_impl(qp, prm)[0]
            fn, args, kw = segment_kernel_call(admm_init(scaled, prm),
                                               scaled, prm)
            rname = ("admm_segment[triangular]_cluster, diff"
                     if fn is K2 else
                     "admm_segment_factored_cluster[refine=1], diff")
            base = ("trinv", "cluster") if fn is K2 else (
                "woodbury_refine1", "cluster")
            kernel_row(rows, name, rname, base, fn, args, kw, c["cluster"])
            added.append(name)
        del qp, sol

    # -- 9b. the turnover chain on net Sharpe ---------------------------------
    D, lam = meta["chain_dates"], meta["lam"]
    prm = params("chain")
    R_np, reb = chain_market(Xo_np[:D])
    R = on(R_np)
    w0 = torch.full((n,), 1.0 / n, dtype=f32, device=dev)
    qps = [pt.build_tracking_qp(Xf[t], yf[t]) for t in range(D)]

    def chain():
        log_lam = torch.tensor(float(np.log(lam)), dtype=f32, device=dev,
                               requires_grad=True)
        wvec = torch.exp(log_lam) * torch.ones(n, dtype=f32, device=dev)
        c, ws = w0, []
        mark, ms = stopwatch(dev)
        mark()
        for t in range(D):
            c = pt.solve_qp_l1_diff(qps[t], wvec, c, prm, device=dev)
            ws.append(c)
        sim = simulate(torch.stack(ws), R, reb, vc=meta["vc"])
        s = net_sharpe(sim.returns, sim.valid.to(f32))
        mark()
        s.backward()
        mark()
        return s.detach(), log_lam.grad, ms()

    chain()
    reset_counts()
    s_card, dlog, (fwd_ms, bwd_ms) = chain()
    c = counts()["K1"]
    carry = np.concatenate([np.full((1, n), 1.0 / n, np.float32),
                            golden["chain/x"][:-1]])
    w_bar, c_bar, status, iters, same = [], [], [], [], []
    names = ("kink", "pos", "neg", "aC", "box", "upC", "upB")
    for t in range(D):
        w = torch.full((n,), lam, dtype=f32, device=dev, requires_grad=True)
        cv = on(carry[t]).requires_grad_(True)
        x = pt.solve_qp_l1_diff(qps[t], w, cv, prm, device=dev)
        x.backward(on(golden["chain/g"][t]))
        one = CanonicalQP(*(None if f is None else f.unsqueeze(0)
                            for f in qps[t]))
        w1, c1 = w.detach().unsqueeze(0), cv.detach().unsqueeze(0)
        sol = pt.solve_qp_batch(one, prm, l1_weight=w1, l1_center=c1,
                                device=dev)
        kink, sign, aC, box, upC, upB = diff.l1_active_sets(one, sol, w1, c1)
        sets = dict(kink=kink, pos=sign > 0, neg=sign < 0, aC=aC, box=box,
                    upC=upC, upB=upB)
        same.append(all(np.array_equal(
            sets[k].cpu().numpy()[0],
            unpack(golden[f"chain/sets/{k}"][t], sets[k].shape[-1]))
            for k in names))
        w_bar.append(w.grad.cpu().numpy())
        c_bar.append(cv.grad.cpu().numpy())
        status.append(int(sol.status[0]))
        iters.append(int(sol.iters[0]))
    status, iters, same = np.asarray(status), np.asarray(iters), np.asarray(
        same)
    same64 = np.ones(D, bool)
    for k in names:
        width = n if k not in ("aC", "upC") else 1
        same64 &= (unpack(golden[f"chain/sets/{k}"], width)
                   == unpack(golden[f"chain/sets/{k}_f64"], width)).all(
            axis=1)
    held = same & (status == golden["chain/status"])
    ok_w, d_w, band_w = twin_rule(np.stack(w_bar), golden["chain/w_bar"],
                                  golden["chain/w_bar_f64"])
    ok_c, d_c, band_c = twin_rule(np.stack(c_bar), golden["chain/c_bar"],
                                  golden["chain/c_bar_f64"])
    ratio = lambda d, b: float(np.max(np.where(held, d / np.where(
        b > 0, b, 1.0), 0.0), initial=0.0))
    print(f"diff [diff_chain]: {D} dates x {n} assets at B = 1; forward "
          f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms (CUDA events); "
          f"launches {c}; net Sharpe {float(s_card):.6f} (golden "
          f"{float(golden['chain/sharpe']):.6f}); dS/dlog(lambda) "
          f"{float(dlog):.6e} (golden f32 {float(golden['chain/dlog_lam']):.6e}"
          f", f64 chain {float(golden['chain/dlog_lam_f64']):.6e}; printed, "
          f"not held); per date from the golden's carry: solved "
          f"{int((status == 1).sum())}/{D}, iterations equal to the golden "
          f"on {int((iters == golden['chain/iters']).sum())}/{D}, the vjp's "
          f"classification equal to the golden's on {int(same.sum())}/{D} "
          f"dates (XLA-CPU f32 to its f64 run: {int(same64.sum())}/{D}); "
          f"on the {int(held.sum())} held dates w_bar max distance/band "
          f"{ratio(d_w, band_w):.3f}, c_bar {ratio(d_c, band_c):.3f}; dates "
          f"past the band: w_bar {np.flatnonzero(~ok_w & held).tolist()}, "
          f"c_bar {np.flatnonzero(~ok_c & held).tolist()}", flush=True)
    check(np.array_equal(status, golden["chain/status"])
          and np.array_equal(iters, golden["chain/iters"]),
          "[diff_chain] per date from the golden's carry: status and "
          "iterations equal the golden's")
    check(int(same.sum()) >= int(same64.sum()),
          f"[diff_chain] the vjp's classification equal to the golden's on "
          f"{int(same.sum())} dates >= XLA-CPU f32 to f64's "
          f"{int(same64.sum())}")
    check(bool(ok_w[held].all()) and bool(ok_c[held].all()),
          f"[diff_chain] per-date w_bar and c_bar within the twin band on "
          f"the {int(held.sum())} dates of equal classification")
    check(bool(np.isfinite(float(dlog))), "[diff_chain] dS/dlog(lambda) "
          "finite")
    check(c["cluster"] > 0 and c["stream"] == 0,
          "[diff_chain] launched the factored kernel's cluster form, never "
          "the streaming one")
    scaled, _, x0_s, y0_s, l1w_s, l1c_s = _prepare_impl(
        CanonicalQP(*(None if f is None else f.unsqueeze(0)
                      for f in qps[2])), prm,
        l1_weight=torch.full((1, n), lam, dtype=f32, device=dev),
        l1_center=on(carry[2:3]))
    fn, args, kw = segment_kernel_call(admm_init(scaled, prm, x0_s, y0_s),
                                       scaled, prm, l1w_s, l1c_s)
    kernel_row(rows, "diff_chain", "admm_segment_factored_cluster[refine=0]"
               ", diff chain", ("woodbury", "cluster"), fn, args, kw,
               c["cluster"])
    added.append("diff_chain")
    del qps

    # -- 9c. the box problem's field gradients, and the controls -------------
    y0 = yf_np[0].astype(np.float64)

    def date0(k, ub, ridge):
        X0 = Xf_np[0][:, :k].astype(np.float64)
        return dict(P=2.0 * X0.T @ X0 + 2.0 * ridge * np.eye(k),
                    q=-2.0 * X0.T @ y0, C=np.ones((1, k)), l=np.ones(1),
                    u=np.ones(1), lb=np.zeros(k), ub=np.full(k, ub),
                    constant=float(y0 @ y0))

    kb = meta["box_assets"]
    parts = date0(kb, meta["box_ub"], meta["ridge"])
    box_fields = ("q", "C", "l", "u", "lb", "ub")
    prm = params("diff_trinv")

    def box_grads():
        qp = CanonicalQP(
            **{k: on(parts[k], dtype=f32).requires_grad_(k in box_fields)
               for k in ("P",) + box_fields},
            var_mask=torch.ones(kb, dtype=f32, device=dev),
            row_mask=torch.ones(1, dtype=f32, device=dev),
            constant=on(parts["constant"], dtype=f32))
        r = Xo[0][:, :kb] @ pt.solve_qp_diff(qp, prm, device=dev) - yo[0]
        torch.sqrt(torch.mean(r * r)).backward()
        return qp, {k: getattr(qp, k).grad.cpu().numpy().reshape(1, -1)
                    for k in box_fields}

    # The problem's f32 floor: XLA-CPU's largest distance to f64 over the
    # fields, relative to each field's scale (the budget row's l
    # cotangent is one number, as a date's dL/dtheta is).
    g32 = {k: golden[f"box/{k}"].astype(np.float64) for k in box_fields}
    g64 = {k: golden[f"box/{k}_f64"].astype(np.float64) for k in box_fields}
    scale = {k: float(np.abs(g64[k]).max()) for k in box_fields}
    floor = max(float(np.abs(g32[k] - g64[k]).max()) / scale[k]
                for k in box_fields if scale[k] > 0)

    def box_rule(grads):
        res = {}
        for k in box_fields:
            d = float(np.abs(grads[k].astype(np.float64) - g64[k]).max())
            band = (KERNEL_VS_PLAIN * floor + GRAD_ULPS * F32_EPS) * scale[k]
            res[k] = (bool(np.isfinite(grads[k]).all()) and d <= band, d,
                      band)
        return all(r[0] for r in res.values()), res

    qp_box, grads = box_grads()
    one = CanonicalQP(*(None if f is None else f.detach().unsqueeze(0)
                        for f in qp_box))
    sol = pt.solve_qp_batch(one, prm, device=dev)
    sets = diff.active_sets(one, sol)
    same_box = all(np.array_equal(
        sets[i].bool().cpu().numpy(),
        unpack(golden[f"box/{key}"].reshape(1, -1), sets[i].shape[-1]))
        for i, key in ((0, "aC"), (2, "aB"), (4, "upC"), (5, "upB")))
    x_box = sol.x[0]
    ok_box, res = box_rule(grads)
    real = diff._qp_cotangents

    def side_blind(*a):
        P_, q_, C_, l_, u_, lb_, ub_ = real(*a)
        return P_, q_, C_, l_, u_, lb_ + ub_, torch.zeros_like(ub_)

    def no_C(*a):
        P_, q_, C_, l_, u_, lb_, ub_ = real(*a)
        return P_, q_, torch.zeros_like(C_), l_, u_, lb_, ub_

    controls = {}
    for tag, fake in (("every box cotangent to lb", side_blind),
                      ("the C cotangent dropped", no_C)):
        diff._qp_cotangents = fake
        try:
            controls[tag] = box_rule(box_grads()[1])[0]
        finally:
            diff._qp_cotangents = real
    print(f"diff [box]: date 0, {kb} assets, ub {meta['box_ub']}, the dense "
          f"adjoint: status "
          f"{int(sol.status[0])} iters {int(sol.iters[0])} (golden "
          f"{int(golden['box/status'])}/{int(golden['box/iters'])}); at lb "
          f"{int((x_box < 1e-6).sum())}, at ub "
          f"{int((x_box > meta['box_ub'] - 1e-6).sum())}; active sets equal "
          f"to the golden's: {same_box}; per field distance/band "
          + ", ".join(f"{k} {r[1]:.3e}/{r[2]:.3e}" for k, r in res.items())
          + f" (f32 floor {floor:.3e} relative)"
          + f"; controls pass the rule: {controls}", flush=True)
    check(int(sol.status[0]) == int(golden["box/status"])
          and int(sol.iters[0]) == int(golden["box/iters"]),
          "[box] status and iterations equal the golden's")
    check(same_box and ok_box, "[box] active sets equal the golden's and "
          "every field's gradient within the twin band")
    for tag, passed in controls.items():
        check(not passed, f"[box] control: a backward with {tag} fails "
              f"the rule")

    # -- 9d. the cross-solver table --------------------------------------------
    from porqua_tpu_torch.compare import compare_solvers

    tables = json.loads(str(golden["compare"]))
    parts = date0(n, meta["compare_ub"], 0.0)
    k = meta["slsqp_assets"]
    sliced = dict(parts, P=parts["P"][:k, :k], q=parts["q"][:k],
                  C=parts["C"][:, :k], lb=parts["lb"][:k], ub=parts["ub"][:k])

    def build(p):
        return CanonicalQP.build(p["P"], p["q"], p["C"], p["l"], p["u"],
                                 p["lb"], p["ub"], constant=p["constant"],
                                 dtype=torch.float64, device=dev)

    full_rows = list(tables["full"])
    df = compare_solvers(build(parts), solvers=full_rows, device=dev)
    reset_counts()
    k2_prm = pt.SolverParams(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000,
                             backend="pallas", linsolve="trinv")
    df_k2 = compare_solvers(build(parts), params=k2_prm,
                            solvers=["device-admm-f32"], device=dev)
    c = counts()["K2"]
    df_s = compare_solvers(build(sliced), solvers=list(tables["slice"]),
                           device=dev)
    metrics = ("objective_value", "primal_residual", "dual_residual",
               "duality_gap", "max_residual_Ab", "max_residual_Gh")

    def within(a, b, tol):
        return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol * max(
            1.0, abs(a), abs(b))

    ok_rows, ok_obj, ok_host = True, True, True
    for tag, table, ref in (("full", df, tables["full"]),
                            ("slice", df_s, tables["slice"]),
                            ("full, K2", df_k2, None)):
        print(f"compare [{tag}] ({card_line()}):\n{table.to_string()}",
              flush=True)
        ipm = (df if tag.startswith("full") else df_s).loc[
            "ipm-f64", "objective_value"]
        for row in table.index:
            r = table.loc[row]
            if "error" in table.columns and isinstance(r["error"], str):
                ok_rows = False
            g = (ref or tables["full"])[row]
            if bool(g["solution_found"]) and not bool(r["solution_found"]):
                ok_rows = False
            if row == "device-admm-f32" and not g["solution_found"]:
                print(f"compare: the golden's device-admm-f32 row is not "
                      f"found at the default eps; the card's found: "
                      f"{bool(r['solution_found'])}", flush=True)
                ok_rows &= not bool(r["solution_found"]) or tag == "full, K2"
            if bool(r["solution_found"]):
                ok_obj &= within(r["objective_value"], ipm, COMPARE_OBJ)
            if ref is not None and row in ("ipm-f64", "native-cpp-admm",
                                           "scipy-slsqp"):
                ok_host &= all(within(float(r[mc]), g[mc], COMPARE_HOST)
                               for mc in metrics)
        if ref is not None:
            ok_rows &= list(table.index) == list(ref)
    check(ok_rows, "[compare] every expected row present, no error, found "
          "wherever the golden's row is found")
    check(ok_obj, f"[compare] every found row's objective within "
          f"{COMPARE_OBJ:g} of ipm-f64's")
    check(ok_host, f"[compare] ipm-f64, native-cpp-admm and scipy-slsqp "
          f"match the golden's objective and residuals to {COMPARE_HOST:g}")
    check(c["cluster"] > 0 and c["stream"] == 0,
          f"[compare] the device-admm-f32 row with backend='pallas' "
          f"launched the triangular-inverse kernel's cluster form ({c})")
    qp32 = CanonicalQP.build(parts["P"], parts["q"], parts["C"], parts["l"],
                             parts["u"], parts["lb"], parts["ub"],
                             constant=parts["constant"], dtype=f32,
                             device=dev)
    k2_run = dataclasses.replace(k2_prm, eps_abs=3e-6, eps_rel=3e-6)
    batch1 = CanonicalQP(*(None if f is None else f.unsqueeze(0)
                           for f in qp32))
    scaled = _prepare_impl(batch1, k2_run)[0]
    fn, args, kw = segment_kernel_call(admm_init(scaled, k2_run), scaled,
                                       k2_run)
    kernel_row(rows, "diff_compare", "admm_segment[triangular]_cluster, "
               "compare", ("trinv", "cluster"), fn, args, kw, c["cluster"])
    added.append("diff_compare")
    return added


def _tiny_requests(n, params):
    """``n`` small well-conditioned QPs (one 8 x 4 bucket: six
    variables, a budget row and one general row) and their reference
    answers (the port's plain path on the CPU): the oracle of the
    calibration and chaos cells, as ``scripts/chaos_suite.py`` builds
    it."""
    import numpy as np

    import porqua_tpu_torch as pt

    qps, refs = [], []
    for seed in range(n):
        rng = np.random.default_rng(seed)
        nv, m = 6, 2
        A = rng.standard_normal((2 * nv, nv))
        P = A.T @ A / (2 * nv) + np.eye(nv)
        q = rng.standard_normal(nv)
        C = np.concatenate([np.ones((1, nv)),
                            rng.standard_normal((m - 1, nv))])
        qp = pt.CanonicalQP.build(P, q, C=C, l=np.full(m, -1.0),
                                  u=np.ones(m), lb=np.zeros(nv),
                                  ub=np.ones(nv), device="cpu")
        qps.append(qp)
        refs.append(pt.solve_qp(qp, dataclasses.replace(
            params, backend="xla"), device="cpu").x.numpy())
    return qps, refs


def _oracle_round(svc, qps, refs, poison=None, before=None):
    """Submit one round of ``qps`` and resolve it: returns ``(results,
    wrong, failures, poisoned_ok, resolutions)``. A result is wrong when
    it is not finite or lies more than CHAOS_ATOL from its reference;
    ``poison(i, qp)`` may corrupt a request (it then must fail);
    ``before(i)`` runs before request ``i`` is submitted; ``resolutions``
    counts each ticket's done callbacks (one each)."""
    import numpy as np

    tickets, poisoned, calls = [], set(), []
    for i, qp in enumerate(qps):
        if before is not None:
            before(i)
        if poison is not None:
            bad = poison(i, qp)
            if bad is not qp:
                poisoned.add(i)
                qp = bad
        t = svc.submit(qp)
        calls.append(0)
        t.future.add_done_callback(
            lambda _f, i=i: calls.__setitem__(i, calls[i] + 1))
        tickets.append(t)
    results, wrong, failures, poisoned_ok = [], [], [], []
    for i, t in enumerate(tickets):
        try:
            res = svc.result(t, timeout=120)
        except Exception as exc:  # noqa: BLE001 - a failure is an outcome
            failures.append(f"req{i}: {type(exc).__name__}")
            results.append(None)
            continue
        results.append(res)
        if i in poisoned:
            poisoned_ok.append(i)
            continue
        if not np.all(np.isfinite(res.x)) or float(
                np.abs(res.x - refs[i]).max()) > CHAOS_ATOL:
            wrong.append(i)
    return results, wrong, failures, poisoned_ok, calls


def _calibration_evidence(cal, bucket, eps, n=6):
    """The calibration smoke's schema-correct evidence for one cell
    (``scripts/calibration_smoke.py::_synthetic_evidence``): PDHG
    strictly faster than the ADMM stream, NAPG matured but slower."""
    for _ in range(n):
        cal.observe({"source": "serve", "bucket": bucket, "eps_abs": eps,
                     "solver": "admm", "status": 1, "iters": 40,
                     "solve_s": 4e-3, "obj": 0.1})
        cal.observe({"source": "serve.shadow", "shadow_of": "admm",
                     "bucket": bucket, "eps_abs": eps, "solver": "pdhg",
                     "status": 1, "iters": 12, "solve_s": 1e-5,
                     "obj": 0.1, "delta_iters": -28,
                     "delta_solve_s": -4e-3, "agree": True})
        cal.observe({"source": "serve.shadow", "shadow_of": "admm",
                     "bucket": bucket, "eps_abs": eps, "solver": "napg",
                     "status": 1, "iters": 80, "solve_s": 8e-3,
                     "obj": 0.1, "delta_iters": 40,
                     "delta_solve_s": 4e-3, "agree": True})


def calibration_cells(device, label):
    """``calibration_promote``, ``calibration_poison`` and
    ``calibration_rollback`` as ``scripts/calibration_smoke.py`` defines
    them and at its sizes (eight 6-variable requests, bucket 8 x 4,
    max_batch 8, eps 1e-5, a Calibrator on a stepped FaultClock), on
    ``device`` through ``backend="pallas"`` (the ADMM arm launches K2).
    Holds: the promotion routes PDHG live with zero recompiles and the
    audit chain replays to the live table and version; poisoned records
    never promote and no poisoned request gets an answer; a rollback
    bumps the version and exactly one flight bundle lands, triggered by
    ``route_rollback``; every answer on ``label``, none wrong. One
    change from the smoke: the poison drill shadows a dispatch with probability
    POISON_SHADOW_RATE, not 1 (a NaN batch runs every backend to
    max_iter, and NAPG's row-by-row bisection makes each such shadow
    cost seconds on the card, launch-bound; the calibrator ticks at
    every dispatch there, so a per-tick budget would not bound it)."""
    import porqua_tpu_torch as pt
    from porqua_tpu_torch import obs
    from porqua_tpu_torch.serve import BucketLadder, SolveService
    from porqua_tpu_torch.serve.routing import SolverRouter

    params = pt.SolverParams(max_iter=500, eps_abs=1e-5, eps_rel=1e-5,
                             polish=False, check_interval=25,
                             backend="pallas")
    qps, refs = _tiny_requests(8, params)
    eps = params.eps_abs

    def service(clk, shadow_rate, **kw):
        sink = obs.HarvestSink(None)
        router = SolverRouter(params, shadow_rate=shadow_rate,
                              shadow_seed=0, cost_log=ROUTER_COST_LOG)
        cal = obs.Calibrator(min_interval_s=0.0, min_samples=4,
                             win_rate=0.6, canary_dwell_s=5.0,
                             guard_window_s=30.0, clock=clk)
        svc = SolveService(
            params, ladder=BucketLadder(n_rungs=(8,), m_rungs=(4,)),
            max_batch=8, max_wait_ms=2.0, queue_capacity=256,
            router=router, harvest=sink, calibrator=cal, device=device,
            **kw)
        return svc, router, cal, sink

    def answered(results):
        return all(r is None or r.device == label for r in results)

    _calibration_promote(service, qps, refs, eps, answered, label)
    _calibration_poison(service, qps, refs)
    _calibration_rollback(service, qps, refs, eps, params, answered, label)


def _calibration_promote(service, qps, refs, eps, answered, label):
    """The promote drill of :func:`calibration_cells`."""
    from porqua_tpu_torch import obs
    from porqua_tpu_torch.resilience import faults

    t0 = time.perf_counter()
    clk = faults.FaultClock()
    svc, router, cal, sink = service(clk, 0.0)
    with svc:
        svc.prewarm(qps[0])
        r0, w0, f0, _, _ = _oracle_round(svc, qps, refs)
        svc.metrics.reset_window()
        bucket = sink.buffered()[0]["bucket"]
        cell = f"{bucket}@{eps:.0e}"
        _calibration_evidence(cal, bucket, eps)
        cal.tick()
        state = cal.status()["state"]
        clk.advance(6.0)
        cal.tick()
        table, version = dict(router.snapshot()["table"]), router.table_version
        r1, w1, f1, _, _ = _oracle_round(svc, qps, refs)
        snap = svc.snapshot()
        clk.advance(31.0)
        cal.tick()
        counters = cal.counters()
        replayed, replay_v = obs.replay_audit(sink.buffered())
        live = router.snapshot()["table"]
    print(f"calibration_promote: {time.perf_counter() - t0:.2f} s; state "
          f"after evidence {state!r}, table {table} (version {version}), "
          f"routed {({m: snap[f'routed_{m}'] for m in ('admm', 'pdhg')})}, "
          f"compiles {snap['compiles']}, counters "
          f"{ {k: v for k, v in counters.items() if v} }", flush=True)
    check(state == "canary" and counters["calibration_promotions"] == 1
          and table.get(cell) == "pdhg" and version == 1
          and snap["routed_pdhg"] == len(qps),
          "[calibration_promote] candidate, canary, promoted (version 1); "
          "the promoted route serves PDHG")
    check(snap["compiles"] == 0,
          "[calibration_promote] the route flip from admm (K2) to PDHG "
          "costs zero recompiles")
    check(replayed == live and replay_v == router.table_version,
          "[calibration_promote] replay_audit of the warehouse gives the "
          "live table and version")
    check(counters["calibration_settled"] == 1
          and counters["calibration_rollbacks"] == 0,
          "[calibration_promote] the guard settles")
    check(not (w0 or w1 or f0 or f1) and answered(r0 + r1),
          f"[calibration_promote] every answer on {label} and right, "
          f"none failed")



def _calibration_poison(service, qps, refs):
    """The poison drill of :func:`calibration_cells`."""
    from porqua_tpu_torch.resilience import RetryPolicy, faults

    t0 = time.perf_counter()
    clk = faults.FaultClock()
    svc, router, cal, sink = service(
        clk, POISON_SHADOW_RATE,
        retry=RetryPolicy(max_attempts=2, backoff_base_s=0.02, seed=0))
    scenario = faults.Scenario("calibration-poison", (faults.FaultSpec.make(
        "data.feed", "feed_corrupt", count=1_000_000, lanes=1),), seed=0)
    poisoned, resolved, calls = 0, [], []
    with svc:
        svc.prewarm(qps[0])

        def poison(i, qp):
            act = faults.fire("data.feed", i=i)
            if act is not None and act.kind == "feed_corrupt":
                return faults.corrupt_feed(qp, act)
            return qp

        with faults.active(scenario, metrics=svc.metrics,
                           events=svc.obs.events):
            for _ in range(2):
                _, _, fails, ok_poisoned, c = _oracle_round(
                    svc, qps, refs, poison)
                poisoned += len(qps)
                resolved += ok_poisoned
                calls += c
                time.sleep(0.25)   # the trailing shadow solves
                clk.advance(10.0)
                cal.tick()
        counters, status = cal.counters(), cal.status()
        snap = svc.snapshot()
    print(f"calibration_poison: {time.perf_counter() - t0:.2f} s; "
          f"{poisoned} poisoned, {len(resolved)} resolved; calibrator "
          f"{ {k: v for k, v in counters.items() if v} }; validation "
          f"failures {snap['validation_failures']}, give-ups "
          f"{snap['retry_giveups']}", flush=True)
    check(counters["calibration_rejected"] > 0
          and counters["calibration_promotions"] == 0
          and counters["calibration_candidates"] == 0
          and status["state"] == "idle" and router.table_version == 0,
          "[calibration_poison] poisoned records are rejected and never "
          "promote")
    check(poisoned > 0 and not resolved and set(calls) == {1},
          "[calibration_poison] no poisoned request gets an answer; every "
          "ticket resolves once")



def _calibration_rollback(service, qps, refs, eps, params, answered, label):
    """The rollback drill of :func:`calibration_cells`."""
    import shutil
    import tempfile

    from porqua_tpu_torch import obs
    from porqua_tpu_torch.resilience import faults

    t0 = time.perf_counter()
    clk = faults.FaultClock()
    anomaly = obs.AnomalyDetector({("drift", eps): {
        "iters_p50": 10.0, "iters_p95": 20.0, "iters_max": 30.0,
        "wasted": 0.0, "count": 100}})
    flight_dir = tempfile.mkdtemp(prefix="calibration-rollback-")
    flight = obs.FlightRecorder(out_dir=flight_dir, armed=False,
                                debounce_s=600.0)
    svc, router, cal, sink = service(clk, 0.0, flight=flight,
                                     anomaly=anomaly)
    try:
        with svc:
            svc.prewarm(qps[0])
            r0, w0, f0, _, _ = _oracle_round(svc, qps, refs)
            svc.metrics.reset_window()
            bucket = sink.buffered()[0]["bucket"]
            cell = f"{bucket}@{eps:.0e}"
            _calibration_evidence(cal, bucket, eps)
            cal.tick()
            clk.advance(6.0)
            cal.tick()
            v_promoted = router.table_version
            t_promoted = dict(router.snapshot()["table"])
            r1, w1, f1, _, _ = _oracle_round(svc, qps, refs)
            for _ in range(8):
                anomaly.observe("drift", eps, 10_000,
                                check_interval=params.check_interval)
            flight.arm()
            clk.advance(1.0)
            cal.tick()
            v_rolled = router.table_version
            t_rolled = dict(router.snapshot()["table"])
            counters = cal.counters()
            replayed, replay_v = obs.replay_audit(sink.buffered())
            bundles = flight.bundles()
            trigger = None
            if len(bundles) == 1:
                b = bundles[0]
                trigger = (obs.load_bundle(b) if isinstance(b, str)
                           else b).get("trigger", {}).get("kind")
            r2, w2, f2, _, _ = _oracle_round(svc, qps, refs)
            snap = svc.snapshot()
            live = router.snapshot()["table"]
    finally:
        shutil.rmtree(flight_dir, ignore_errors=True)
    print(f"calibration_rollback: {time.perf_counter() - t0:.2f} s; "
          f"promoted {t_promoted} (version {v_promoted}), restored "
          f"{t_rolled} (version {v_rolled}); bundles {len(bundles)} "
          f"(trigger {trigger!r}); compiles {snap['compiles']}", flush=True)
    check(t_promoted.get(cell) == "pdhg" and t_rolled == {}
          and counters["calibration_rollbacks"] == 1
          and v_promoted == 1 and v_rolled == 2,
          "[calibration_rollback] the rollback restores the table and "
          "bumps the version (1 -> 2), never reusing one")
    check(len(bundles) == 1 and trigger == "route_rollback",
          "[calibration_rollback] exactly one flight bundle, triggered by "
          "route_rollback")
    check(replayed == live and replay_v == v_rolled,
          "[calibration_rollback] replay_audit gives the live table and "
          "version")
    check(snap["compiles"] == 0 and not (w0 or w1 or w2 or f0 or f1 or f2)
          and answered(r0 + r1 + r2),
          f"[calibration_rollback] zero recompiles; every answer on "
          f"{label} and right")


def chaos_cells(device, label):
    """``solver_route_flap`` (``scripts/chaos_suite.py:463``: a live
    router force-flipped across ADMM, PDHG and NAPG mid-round) and the
    port's builtin fault scenarios, each on the chaos suite's sixteen
    6-variable requests (bucket 8 x 4, max_batch 8) under a
    ``RetryPolicy`` (the default for the flap, the suite's for the
    faults: four attempts, 20 ms backoff), on ``device``. The service
    names no fallback, so the breaker and the retries stay on the card.
    Holds, per cell: every answer returned is finite and within
    CHAOS_ATOL of its oracle, no poisoned request resolves, every ticket
    resolves once, every answer on ``label``; the flap serves every
    backend with zero recompiles and no failure; each fault fired."""
    import porqua_tpu_torch as pt
    from porqua_tpu_torch import obs
    from porqua_tpu_torch.resilience import RetryPolicy, faults
    from porqua_tpu_torch.serve import BucketLadder, SolveService
    from porqua_tpu_torch.serve.routing import SolverRouter

    params = pt.SolverParams(max_iter=500, eps_abs=1e-5, eps_rel=1e-5,
                             polish=False, check_interval=25,
                             backend="pallas")
    qps, refs = _tiny_requests(16, params)
    ladder = BucketLadder(n_rungs=(8,), m_rungs=(4,))

    # solver_route_flap
    t0 = time.perf_counter()
    router = SolverRouter(params, cost_log=ROUTER_COST_LOG)
    svc = SolveService(params, ladder=ladder, max_batch=8, max_wait_ms=5.0,
                       queue_capacity=256, router=router,
                       retry=RetryPolicy(), obs=obs.Observability(),
                       device=device)
    wrong, failures, calls, results = [], [], [], []
    with svc:
        svc.prewarm(qps[0])
        svc.metrics.reset_window()
        half = len(qps) // 2
        for start, mid in (("pdhg", "admm"), ("admm", "napg"),
                           ("napg", "pdhg"), ("pdhg", None),
                           ("napg", None), (None, None)):
            router.force(start)
            r, w, f, _, c = _oracle_round(
                svc, qps, refs,
                before=lambda i, mid=mid: i == half and router.force(mid))
            results += [x for x in r if x is not None]
            wrong += w
            failures += f
            calls += c
        snap = svc.snapshot()
    routed = {m: snap[f"routed_{m}"] for m in ("admm", "pdhg", "napg")}
    print(f"chaos solver_route_flap: {time.perf_counter() - t0:.2f} s; "
          f"routed {routed}, compiles {snap['compiles']}, wrong "
          f"{len(wrong)}, failed {len(failures)}", flush=True)
    check(not wrong and not failures and set(calls) == {1}
          and all(r.device == label for r in results),
          f"[solver_route_flap] every answer right and on {label}, none "
          f"failed, every ticket resolved once")
    check(all(routed.values()) and snap["compiles"] == 0,
          "[solver_route_flap] every backend served, zero recompiles")

    # The builtin fault scenarios the service's seams fire.
    for name, feed in (("device_lost", False), ("nan_lanes", False),
                       ("feed_corrupt", True), ("compile_storm", False),
                       ("queue_stall", False), ("clock_skew", False)):
        t0 = time.perf_counter()
        scenario = faults.builtin_scenarios(seed=0)[name]
        svc = SolveService(
            params, ladder=ladder, max_batch=8, max_wait_ms=5.0,
            queue_capacity=256, obs=obs.Observability(),
            retry=RetryPolicy(max_attempts=4, backoff_base_s=0.02, seed=0),
            device=device)

        def poison(i, qp):
            act = faults.fire("data.feed", i=i)
            if act is not None and act.kind == "feed_corrupt":
                return faults.corrupt_feed(qp, act)
            return qp

        wrong, failures, poisoned_ok, calls, results = [], [], [], [], []
        with svc:
            svc.prewarm(qps[0])
            svc.metrics.reset_window()
            with faults.active(scenario, metrics=svc.metrics,
                               events=svc.obs.events) as injector:
                for _ in range(2):
                    r, w, f, p, c = _oracle_round(
                        svc, qps, refs, poison if feed else None)
                    results += r
                    wrong += w
                    failures += f
                    poisoned_ok += p
                    calls += c
                fired = injector.fires()
            r, w, f, _, c = _oracle_round(svc, qps, refs)
            results += r
            wrong += w
            calls += c
            snap = svc.snapshot()
        print(f"chaos {name}: {time.perf_counter() - t0:.2f} s; faults "
              f"fired {fired}; failed {len(failures)} in the window, "
              f"{len(f)} after; retries {snap['retries']}, validation "
              f"failures {snap['validation_failures']}, give-ups "
              f"{snap['retry_giveups']}", flush=True)
        check(fired > 0 and not wrong and not poisoned_ok
              and set(calls) == {1}
              and all(x is None or x.device == label for x in results),
              f"[{name}] faults fired; every answer returned right and on "
              f"{label}; no poisoned answer; every ticket resolved once")


def _scrape(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def _replay_batches(spans, by_trace):
    """The hooked run's dispatched batches from its ``solve`` spans:
    lists of request indices, in the order the batcher stacked them
    (one batch per distinct (start, end) of the span, its lanes in the
    order their spans were recorded)."""
    batches = {}
    for s in spans:
        if s.name == "solve" and s.trace_id in by_trace:
            batches.setdefault((s.t_start, s.t_end, s.args.get("slots")),
                               []).append(by_trace[s.trace_id])
    return [(key[2], lanes) for key, lanes in sorted(batches.items())]


def routed_serve_phase(rows, reset_counts, device="cuda",
                       bare_bursts=None):
    """Phase 10: the routed, retried and observed service on ``device``
    (the card); returns the kernel rows it adds to ``rows``.
    ``bare_bursts``: phase 7's burst numbers, printed beside the hooked
    ones.

    (a) Phase 7's north-star stream (512 requests x 500 assets, bucket
    512 x 8, max_batch 256, one burst) through ``SolveService(router=
    SolverRouter(admm, pdhg, napg), retry=RetryPolicy(), obs=, harvest=,
    slo=, flight=, anomaly=)``: the router's table seeded from the
    golden's aggregate (it must build the JAX package's table), then
    512 x 8 routed to admm by a versioned ``set_table``; the anomaly
    baseline from the golden's aggregate. Runs: ``routed_trinv``
    (classic, K2; shadow_rate 1 with a budget of SHADOW_BUDGET),
    ``routed_continuous`` (K2; the continuous batcher shadows nothing,
    as in the JAX package) and ``routed_woodbury`` (classic, K1 r0;
    budget 0: the golden holds the losers' answers under the dense
    params only). Holds, per run: every request against
    ``serve_golden.npz`` by phase 7's rule; every served record
    ``cuda:0`` and ``admm``, one per request; every shadow record
    against the route golden's answer for its request and loser
    (SHADOW rule); the classic runs' dispatched batches (from the
    spans) replayed through a bare compiled entry launch the same
    kernels the same number of times with the same bits; zero compiles
    after prewarm; a ``/metrics`` scrape equal to the snapshot.
    (b) The three-tenant blend (tracking on admm/K2, LAD on PDHG,
    turnover on NAPG) with ``TenantSLOSet``, every answer against the
    golden; K2's launches, counted from zero after the prewarm, equal
    the segments of the tracking tenant's dispatches (from the spans),
    by batch width. (c) The calibration cells; (d) chaos with retries."""
    import tempfile

    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import obs
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.qp.canonical import stack_qps
    from porqua_tpu_torch.resilience import RetryPolicy
    from porqua_tpu_torch.serve import SolveService, workloads
    from porqua_tpu_torch.serve.loadgen import build_tracking_requests
    from porqua_tpu_torch.serve.metrics import COUNTERS
    from porqua_tpu_torch.serve.routing import SolverRouter

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, SERVE_PATH))
    route = np.load(os.path.join(here, ROUTE_PATH))
    meta = json.loads(str(golden["meta"]))
    rmeta = json.loads(str(route["meta"]))
    agg = json.loads(str(route["aggregate"]))
    n = meta["n_assets"]
    dev = torch.device(device)
    label = f"{dev.type}:{dev.index or 0}"
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment
    requests = {factor: build_tracking_requests(
        meta["n_requests"], n, meta["window"], meta["seed"], factor)
        for factor in (False, True)}
    runs = (("routed_trinv", "trinv", False, K2, SHADOW_BUDGET),
            ("routed_continuous", "trinv", True, K2, 0),
            ("routed_woodbury", "woodbury", False, K1, 0))
    launches, calls = {}, {}
    bare_bursts = bare_bursts or {}
    tmp = tempfile.mkdtemp(prefix="porqua-phase10-")

    def burst(svc, reqs):
        tickets = [svc.submit(q) for q in reqs]
        return [svc.result(t, timeout=600) for t in tickets]

    for tag, config, continuous, wrapper, budget in runs:
        t_run = time.perf_counter()
        p = json.loads(str(golden[f"{config}/params"]))
        params = pt.SolverParams(**{**p, "backend": "pallas"})
        reqs = requests[config == "woodbury"]
        calls[tag] = (params, reqs)
        eps = params.eps_abs
        router = SolverRouter(params, shadow_rate=1.0 if budget else 0.0,
                              shadow_seed=0,
                              shadow_budget_per_tick=budget,
                              cost_log=ROUTER_COST_LOG)
        seeded = router.seed_from_aggregate(agg)
        snap0 = router.snapshot()
        check(snap0["table"] == rmeta["seeded"]
              and snap0["table_version"] == rmeta["seeded_version"],
              f"[{tag}] seed_from_aggregate builds the JAX package's table "
              f"{rmeta['seeded']} (version {rmeta['seeded_version']})")
        bucket = f"{pt.serve.BucketLadder().select(reqs[0]).n}x" \
                 f"{pt.serve.BucketLadder().select(reqs[0]).m}"
        version = router.set_table({(bucket, eps): "admm"})
        hpath = os.path.join(tmp, f"{tag}.jsonl")
        sink = obs.HarvestSink(hpath)
        o = obs.Observability()
        flight = obs.FlightRecorder(out_dir=os.path.join(tmp, tag))
        svc = SolveService(
            params, max_batch=STREAM_MAX_BATCH, max_wait_ms=2.0,
            warm_start=False, continuous=continuous, router=router,
            retry=RetryPolicy(),
            obs=o, harvest=sink, slo=obs.SLOEngine(obs.default_slos()),
            flight=flight,
            anomaly=obs.AnomalyDetector.from_aggregate(agg),
            device=device)
        svc.start()
        try:
            t0 = time.perf_counter()
            n_prewarm = svc.prewarm(reqs[0])
            prewarm_s = time.perf_counter() - t0
            reset_counts()
            t0 = time.perf_counter()
            res = burst(svc, reqs)
            burst_s = time.perf_counter() - t0
            time.sleep(0.2)   # the last dispatch's plane tick
            launches[tag] = {"cluster": wrapper.cluster_launches,
                             "stream": wrapper.stream_launches,
                             "widths": dict(wrapper.widths)}
            snap = svc.snapshot()
            port = svc.start_http()
            scraped = _scrape(port, "/metrics")
            health = json.loads(_scrape(port, "/healthz"))
            vitals = svc.vitals()
            after = svc.snapshot()
            if tag == "routed_trinv":
                profile_run(lambda: burst(svc, reqs),
                            f"profile [{tag} burst of {len(reqs)}, hooks "
                            f"on]")
            spans = o.spans.spans()
            rsnap = router.snapshot()
            slo_status = svc.slo.status()
            anomaly_status = svc.anomaly.status()
        finally:
            svc.stop()
            sink.close()
        # The burst's records (the profiled burst adds its own).
        traces = {r.trace_id for r in res}
        records = [r for r in obs.load_harvest(hpath)
                   if r.get("trace_id") in traces]
        served = [r for r in records if r["source"] != "serve.shadow"]
        shadows = [r for r in records if r["source"] == "serve.shadow"]
        status = np.array([r.status for r in res])
        iters = np.array([r.iters for r in res])
        x = np.stack([r.x for r in res])
        dx = np.abs(x - golden[f"{config}/x"]).max(axis=1)
        print(f"{tag}: prewarm {n_prewarm} entries (3 backends) in "
              f"{prewarm_s:.2f} s; table version {version} "
              f"({rsnap['table']}); burst of {len(res)} in "
              f"{burst_s * 1e3:.1f} ms ({len(res) / burst_s:.1f} solves/s; "
              f"p50 {snap['latency_p50_ms']:.1f} ms, p99 "
              f"{snap['latency_p99_ms']:.1f} ms; bare, phase 7: "
              f"{bare_bursts.get(tag.replace('routed', 'serve'), {})}); "
              f"launches {launches[tag]}; solved "
              f"{int((status == 1).sum())}/{len(status)}, max|dx| "
              f"{float(dx.max()):.3e}; records {len(served)} served, "
              f"{len(shadows)} shadow (shadow solves "
              f"{rsnap['shadow_solves']} in "
              f"{sum({r['solve_s'] for r in shadows}):.2f} s on "
              f"{sorted({r['solver'] for r in shadows})}, deferred "
              f"{rsnap['shadow_deferred']}); SLO firing "
              f"{slo_status['firing']}, compliance "
              f"{ {k: v['compliance'] for k, v in slo_status['slos'].items()} }; "
              f"anomalies {anomaly_status.get('fired')}; flight bundles "
              f"{len(flight.bundles())}", flush=True)
        check(np.array_equal(status, golden[f"{config}/status"])
              and np.array_equal(iters, golden[f"{config}/iters"])
              and float(dx.max()) <= W_ATOL and x.shape == (len(res), n),
              f"[{tag}] {len(res)}/{len(res)} requests equal serve_golden "
              f"(status, iterations, max|dx| {float(dx.max()):.3e} <= "
              f"{W_ATOL:g})")
        check(launches[tag]["cluster"] > 0 and launches[tag]["stream"] == 0,
              f"[{tag}] launched the cluster form ({launches[tag]})")
        check(len(served) == len(res)
              and all(r["device"] == label and r["solver"] == "admm"
                      for r in served)
              and all(r.device == label for r in res),
              f"[{tag}] one record per request, every one {label} and "
              f"admm")
        check(snap["compiles"] == n_prewarm and after["compiles"]
              == n_prewarm, f"[{tag}] zero compiles after prewarm "
              f"({n_prewarm} at prewarm)")
        prom = {}
        for line in scraped.splitlines():
            if line.startswith("porqua_serve_") and " " in line \
                    and "{" not in line:
                k, v = line.split(" ", 1)
                prom[k[len("porqua_serve_"):]] = float(v)
        mismatch = {k: (prom.get(k), after[k]) for k in COUNTERS
                    if k in after and prom.get(k) != float(after[k])}
        check(not mismatch, f"[{tag}] the /metrics scrape's counters equal "
              f"ServeMetrics.snapshot() ({len(COUNTERS)} counters; "
              f"mismatch {mismatch})")
        print(f"{tag}: /healthz {json.dumps({k: health[k] for k in ('ok', 'degraded', 'device', 'harvest_records')})}; "
              f"vitals {vitals}", flush=True)
        # Shadows: each lane against the golden's answer on its loser.
        if budget:
            by_trace = {r.trace_id: i for i, r in enumerate(res)}
            lanes = [(by_trace[s["trace_id"]], s["solver"], s["status"],
                      s["iters"]) for s in shadows]
            g = {m: (route[f"stream/{m}/status"], route[f"stream/{m}/iters"])
                 for m in ("pdhg", "napg")}
            ok, report = shadow_rule(lanes, g, params.check_interval)
            # The control: each lane held against the other loser's
            # golden answer must fail the rule.
            other = {"pdhg": "napg", "napg": "pdhg"}
            control = [(i, other[m], s_, it) for i, m, s_, it in lanes]
            bad, creport = shadow_rule(control, g, params.check_interval)
            print(f"{tag}: shadows {report}; control (the other loser's "
                  f"golden) "
                  f"{creport}", flush=True)
            check(lanes and ok, f"[{tag}] every shadow lane matches the "
                  f"golden's answer on its loser ({len(lanes)} lanes)")
            check(not bad, f"[{tag}] the shadow rule's control fails it")
        # Hooks are invisible: replay the dispatched batches bare.
        if not continuous:
            by_trace = {r.trace_id: i for i, r in enumerate(res)}
            batches = _replay_batches(spans, by_trace)
            cache = pt.serve.ExecutableCache(params)
            ladder = pt.serve.BucketLadder()
            for slots, lanes in batches:
                cache.get(ladder.select(reqs[0]), slots, torch.float32,
                          dev)
            reset_counts()
            same = True
            for slots, lanes in batches:
                padded = [ladder.pad(reqs[i])[1] for i in lanes]
                padded += [padded[j % len(lanes)]
                           for j in range(slots - len(lanes))]
                qp = stack_qps(padded)
                x0 = torch.zeros((slots, qp.n), dtype=qp.q.dtype)
                y0 = torch.zeros((slots, qp.m), dtype=qp.q.dtype)
                sol = cache.get(ladder.select(reqs[0]), slots,
                                torch.float32, dev)(qp, x0, y0)
                xs = sol.x.cpu().numpy()
                st = sol.status.cpu().numpy()
                it = sol.iters.cpu().numpy()
                for j, i in enumerate(lanes):
                    same &= (np.array_equal(xs[j, :n], res[i].x)
                             and int(st[j]) == res[i].status
                             and int(it[j]) == res[i].iters)
            bare = {"cluster": wrapper.cluster_launches,
                    "stream": wrapper.stream_launches,
                    "widths": dict(wrapper.widths)}
            print(f"{tag}: replayed {len(batches)} batches (slots "
                  f"{[s for s, _ in batches]}) bare: launches {bare}",
                  flush=True)
            check(sum(len(b) for _, b in batches) == len(res) and same
                  and bare == launches[tag],
                  f"[{tag}] the hooked run's batches replayed through the "
                  f"bare entry: the same launches and the same bits")
        print(f"{tag}: {time.perf_counter() - t_run:.1f} s", flush=True)

    # (b) the blend
    t0 = time.perf_counter()
    bl = rmeta["blend"]
    specs = workloads.parse_tenant_specs(bl["spec"])
    base = json.loads(str(golden["trinv/params"]))
    params = pt.SolverParams(**{**base, "backend": "pallas"})
    router = SolverRouter(params, cost_log=ROUTER_COST_LOG)
    table = {(rmeta["blend_buckets"][s.name], params.eps_abs):
             bl["routes"][s.name] for s in specs}
    router.set_table(table)
    tenant_slos = obs.TenantSLOSet()
    o = obs.Observability()
    svc = SolveService(params, max_batch=BLEND_MAX_BATCH, max_wait_ms=2.0,
                       warm_start=False, router=router, obs=o,
                       tenant_slos=tenant_slos, device=device)
    pools, order = {}, []
    for spec in specs:
        pools[spec.name] = workloads.build_problems(spec, seed=bl["seed"])
        for j, t in enumerate(workloads.arrival_times(
                spec, bl["duration_s"], seed=bl["seed"])):
            order.append((float(t), spec.name, j % spec.pool))
    order.sort(key=lambda row: (row[0], row[1]))
    with svc:
        # Each tenant bucket's ADMM ladder (K2 must fit every bucket)
        # and its routed backend's; not NAPG's at the LAD bucket: NAPG
        # projects rows one at a time, and its warm-up over a 512-row
        # bucket would take minutes on the card (PERF.md section 4).
        n_prewarm = 0
        for s in specs:
            bucket = svc.ladder.select(pools[s.name][0])
            for m in sorted({"admm", bl["routes"][s.name]}):
                n_prewarm += router.caches[m].prewarm(
                    bucket, BLEND_MAX_BATCH, torch.float32, dev)
        svc.metrics.reset_window()
        # The prewarm ran K2 on neutral batches: count from here.
        reset_counts()
        t_blend = time.perf_counter()
        tickets = []
        for t, name, j in order:
            delay = t_blend + t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            tickets.append(svc.submit(pools[name][j], tenant=name))
        res = [svc.result(tk, timeout=600) for tk in tickets]
        blend_s = time.perf_counter() - t_blend
        k2_blend = {"cluster": K2.cluster_launches,
                    "stream": K2.stream_launches,
                    "widths": dict(K2.widths)}
        snap = svc.snapshot()
        tslo = tenant_slos.status()
    # The tracking tenant's dispatches (the only ones routed to admm):
    # each runs ceil(max iterations / check interval) segments, one K2
    # launch apiece, at its slot count.
    admm_tenants = {s.name for s in specs if bl["routes"][s.name] == "admm"}
    by_trace = {r.trace_id: i for i, ((_, name, _), r)
                in enumerate(zip(order, res)) if name in admm_tenants}
    ci = params.check_interval
    want = {}
    admm_batches = _replay_batches(o.spans.spans(), by_trace)
    for slots, lanes in admm_batches:
        segs = max(-(-max(res[i].iters for i in lanes) // ci), 1)
        want[slots] = want.get(slots, 0) + segs
    per = {}
    for (t, name, j), r in zip(order, res):
        per.setdefault(name, []).append((j, r))
    ok = True
    for spec in specs:
        g_st = route[f"blend/{spec.name}/status"]
        g_it = route[f"blend/{spec.name}/iters"]
        g_x = route[f"blend/{spec.name}/x"]
        got = per.get(spec.name, [])
        st = np.array([r.status for _, r in got])
        it = np.array([r.iters for _, r in got])
        js = np.array([j for j, _ in got])
        dx = np.array([np.abs(r.x - g_x[j]).max() for j, r in got])
        ok_t = (len(got) > 0 and np.array_equal(st, g_st[js])
                and bool((np.abs(it - g_it[js]) <= ci).all())
                and float(dx.max()) <= W_ATOL)
        # Control: the answers held against the next pool problem's.
        other = (js + 1) % len(g_st)
        cdx = np.array([np.abs(r.x - g_x[o]).max()
                        for (_, r), o in zip(got, other)])
        ok &= ok_t and float(cdx.min()) > W_ATOL
        print(f"blend {spec.name} ({spec.problem}, "
              f"{rmeta['blend_buckets'][spec.name]} on "
              f"{bl['routes'][spec.name]}): {len(got)} requests, solved "
              f"{int((st == 1).sum())}, iterations equal on "
              f"{int((it == g_it[js]).sum())}, max|diters| "
              f"{int(np.abs(it - g_it[js]).max()) if len(got) else 0}, "
              f"max|dx| {float(dx.max()) if len(got) else 0:.3e} "
              f"(control, the next pool problem's answer: min "
              f"{float(cdx.min()) if len(got) else 0:.3e}); tenant SLO firing "
              f"{tslo.get(spec.name, {}).get('firing')}",
              flush=True)
    routed = {m: snap[f"routed_{m}"] for m in ("admm", "pdhg", "napg")}
    print(f"blend: {len(res)} requests in {blend_s:.2f} s (prewarm "
          f"{n_prewarm} entries), routed {routed}, K2 launches {k2_blend} "
          f"for {len(admm_batches)} admm dispatches (segments by width "
          f"{want}), compiles after prewarm {snap['compiles']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(ok, f"[blend] every answer equals the golden (status; "
          f"iterations within one check interval; |dx| <= "
          f"{W_ATOL:g}) and the control fails")
    check(all(r.device == label for r in res)
          and snap["compiles"] == 0 and snap["failed"] == 0,
          f"[blend] every answer on {label}; zero compiles after prewarm")
    check(admm_batches and k2_blend["cluster"] > 0
          and k2_blend["stream"] == 0
          and k2_blend["widths"] == want
          and sum(len(b) for _, b in admm_batches) == len(by_trace),
          f"[blend] the tracking tenant launched K2 once per segment of "
          f"its {len(admm_batches)} dispatches, in the cluster form "
          f"({k2_blend})")

    # (c) calibration, (d) chaos
    t0 = time.perf_counter()
    calibration_cells(device, label)
    print(f"calibration cells: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    chaos_cells(device, label)
    print(f"chaos cells: {time.perf_counter() - t0:.1f} s", flush=True)

    added = []
    for key, rname, base_row, tag in (
            ("routed_k2", "admm_segment[triangular]_cluster, routed serve",
             ("trinv", "cluster"), "routed_trinv"),
            ("routed_k1",
             "admm_segment_factored_cluster[refine=0], routed serve",
             ("woodbury", "cluster"), "routed_woodbury")):
        params, reqs = calls[tag]
        fn, args, kw = serve_kernel_call(reqs[:256], params, dev)
        kernel_row(rows, key, rname, base_row, fn, args, kw,
                   launches[tag]["cluster"])
        added.append(key)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return added


def _kernel_flops_of(tag, slots, wrapper, reqs, params, device):
    """``launch_cost`` of one launch of ``wrapper`` at the entry width
    ``slots``: the call the first segment of a batch of ``slots``
    requests makes (only its shapes matter)."""
    from porqua_tpu_torch.ops import admm_kernel

    fn, args, kw = serve_kernel_call(reqs[:slots], params, device)
    check(fn is wrapper,
          f"[{tag}] the {slots}-slot entry launches {wrapper.__name__}")
    return admm_kernel.launch_cost(fn.__name__, args, kw)[0]


def _trace_kernels(path, name, exclude=None):
    """(events, device microseconds) of the kernels in a Chrome trace
    whose name contains ``name`` (and not ``exclude``)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    hits = [e for e in events if e.get("cat") == "kernel"
            and name in str(e.get("name", ""))
            and (exclude is None or exclude not in str(e.get("name", "")))]
    return len(hits), sum(float(e.get("dur", 0.0)) for e in hits)


def cost_phase(rows, reset_counts, device="cuda"):
    """Phase 11: the device-cost plane on ``device`` (the card); returns
    the kernel rows it adds to ``rows``.

    Phase 7's north-star stream (512 requests x 500 assets, bucket
    512 x 8, max_batch 256; max_wait long enough that the burst forms
    two full batches, so two services dispatch the same batches) runs
    through ``cost_trinv`` (K2) and ``cost_woodbury`` (K1 r0), each
    served by a service with the plane on (``CostLog`` on disk,
    ``HarvestSink``, ``Observability``, a ``StageProfiler``) and one
    with ``cost_log=False``; prewarm seconds of both printed. Checks:
    - one CostRecord per entry the ladder built, each on ``cuda:0``
      with flops, bytes accessed and peak bytes above 0, the file on
      disk holding the same records; each record's ``kernel_flops``
      equal to the wrapper's launches at that width (counted from zero
      before the prewarm) times ``launch_cost`` at that width; the op
      hash equal for the same entry built by a second cache, and
      different between the trinv and woodbury entries;
    - every answer equal to ``serve_golden.npz`` by phase 7's rule, and
      the plane-off service's answers the same bits;
    - every harvest record a ``profile`` with ``cost_source`` "torch"
      and the MFU fields of the card's peaks;
    - a ``ProfileWindow`` over the burst stops by its timer and writes a
      trace that names the kernel with device time;
    - ``roofline_verdict`` with the card's ridge point and a ranking,
      ``render_report`` with all nine sections, a ledger row appended,
      read back and its rolling median;
    - a ``FleetCollector`` over two ``WorkerStream``s, fed by two
      services sharing the card and splitting the stream, reconciles:
      fleet completed = the workers' completed = their harvest
      records; zero compiles after prewarm on both."""
    import tempfile

    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    from porqua_tpu_torch import obs
    from porqua_tpu_torch.obs import devprof
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.profiling import device_peaks
    from porqua_tpu_torch.serve import (BucketLadder, ExecutableCache,
                                        SolveService, slot_ladder)
    from porqua_tpu_torch.serve.loadgen import build_tracking_requests

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    golden = np.load(os.path.join(here, SERVE_PATH))
    meta = json.loads(str(golden["meta"]))
    n = meta["n_assets"]
    dev = torch.device(device)
    label = f"{dev.type}:{dev.index or 0}"
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment
    runs = (("cost_trinv", "trinv", K2, "dense_cluster_kernel", None),
            ("cost_woodbury", "woodbury", K1, "cluster_kernel",
             "dense_cluster_kernel"))
    requests = {factor: build_tracking_requests(
        meta["n_requests"], n, meta["window"], meta["seed"], factor)
        for factor in (False, True)}
    tmp = tempfile.mkdtemp(prefix="porqua-phase11-")
    ladder = slot_ladder(STREAM_MAX_BATCH)
    launches, calls, hashes = {}, {}, {}
    # The counter's first use imports torch's dispatch-mode and flop
    # counting machinery, once per process: paid here, so that the
    # prewarm times below compare the plane on and off.
    t0 = time.perf_counter()
    devprof.count_call(torch.matmul, torch.ones(2, 2, device=dev),
                       torch.ones(2, 2, device=dev))
    print(f"phase 11: the cost counter's first use (imports) "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def burst(svc, reqs):
        tickets = [svc.submit(q) for q in reqs]
        return [svc.result(t, timeout=600) for t in tickets]

    def service(params, **kw):
        return SolveService(params, max_batch=STREAM_MAX_BATCH,
                            max_wait_ms=COST_MAX_WAIT_MS, warm_start=False,
                            device=device, **kw)

    for tag, config, wrapper, kname, kexclude in runs:
        t_run = time.perf_counter()
        p = json.loads(str(golden[f"{config}/params"]))
        params = pt.SolverParams(**{**p, "backend": "pallas"})
        reqs = requests[config == "woodbury"]
        calls[tag] = (params, reqs)
        bucket = BucketLadder().select(reqs[0])

        # -- prewarm with the plane off, then on -------------------------
        off = service(params, cost_log=False)
        t0 = time.perf_counter()
        off.prewarm(reqs[0])
        prewarm_off = time.perf_counter() - t0
        check(off.cache.cost_records() == [],
              f"[{tag}] cost_log=False harvests nothing")
        log_path = os.path.join(tmp, f"{tag}.costs.jsonl")
        log = obs.CostLog(log_path)
        sink = obs.HarvestSink(None)
        o = obs.Observability()
        profiler = obs.StageProfiler()
        on = service(params, cost_log=log, harvest=sink, obs=o,
                     profiler=profiler)
        reset_counts()
        t0 = time.perf_counter()
        n_prewarm = on.prewarm(reqs[0])
        prewarm_on = time.perf_counter() - t0
        widths = dict(wrapper.widths)
        records = sorted(on.cache.cost_records(), key=lambda r: r["slots"])
        log.flush()
        on_disk = devprof.load_cost_records(log_path)
        print(f"{tag}: prewarm {n_prewarm} entries, plane off "
              f"{prewarm_off:.3f} s, plane on {prewarm_on:.3f} s; "
              f"warm-up launches by width {widths}", flush=True)
        for r in records:
            print(f"  {r['entry']} x{r['slots']}: flops {r['flops']:.6g} "
                  f"(kernel {r['kernel_flops']:.6g}, share "
                  f"{r['kernel_flops'] / r['flops']:.4f}), bytes "
                  f"{r['bytes_accessed']:.6g} (kernel "
                  f"{r['kernel_bytes']:.6g}, share "
                  f"{r['kernel_bytes'] / r['bytes_accessed']:.4f}), peak "
                  f"{r['peak_bytes']} B (temp {r['temp_bytes']}), "
                  f"segments {r['segments']}, launches "
                  f"{r['kernel_launches']}, hash {r['hlo_hash']}, "
                  f"warm-up {r['compile_s']:.3f} s", flush=True)
        check(len(records) == n_prewarm == len(ladder)
              and [r["slots"] for r in records] == list(ladder)
              and all(r["entry"] == "solve" and r["device"] == label
                      and r["cost_source"] == "torch" for r in records),
              f"[{tag}] one CostRecord per built entry ({len(records)} "
              f"for {n_prewarm}), every one {label}")
        check(all(r["flops"] > 0 and r["bytes_accessed"] > 0
                  for r in records),
              f"[{tag}] every record has flops and bytes accessed above 0")
        check(all((r["peak_bytes"] or 0) > 0 for r in records),
              f"[{tag}] every record has peak bytes above 0")
        check(len(on_disk) == len(records) and sorted(
            (r["slots"], r["hlo_hash"]) for r in on_disk) == [
            (r["slots"], r["hlo_hash"]) for r in records],
              f"[{tag}] the CostLog on disk holds the same {len(on_disk)} "
              f"records")
        want = {s: widths.get(s, 0) * _kernel_flops_of(tag, s, wrapper, reqs,
                                                       params, dev)
                for s in ladder}
        got = {r["slots"]: r["kernel_flops"] for r in records}
        counted = {r["slots"]: sum(r["kernel_launches"].values())
                   for r in records}
        check(got == want and counted == {s: widths.get(s, 0)
                                          for s in ladder}
              and all(v > 0 for v in widths.values())
              and set(widths) == set(ladder),
              f"[{tag}] kernel_flops = launches x launch_cost at every "
              f"width (launches {widths}; mismatch "
              f"{ {s: (got[s], want[s]) for s in ladder if got[s] != want[s]} })")
        twin = ExecutableCache(params)
        twin.get(bucket, ladder[-1], torch.float32, dev)
        again = twin.cost_record_for(bucket, ladder[-1], torch.float32,
                                     device_label=label)
        hashes[tag] = records[-1]["hlo_hash"]
        check(again is not None and again["hlo_hash"] == hashes[tag],
              f"[{tag}] the same entry built by a second cache has the "
              f"same op hash ({hashes[tag]})")
        gauges = on.cache.prometheus_gauges()["bucket_peak_bytes"]
        check(len(gauges) == 1 and gauges[0][1] == max(
            r["peak_bytes"] for r in records),
              f"[{tag}] /metrics' bucket_peak_bytes is the bucket's "
              f"largest peak ({gauges})")

        # -- the burst: plane on under a profiler window, then off --------
        on.start()
        off.start()
        try:
            window = devprof.ProfileWindow(os.path.join(tmp, f"{tag}.trace"),
                                           window_s=COST_WINDOW_S)
            reset_counts()
            window.start()
            t0 = time.perf_counter()
            res = burst(on, reqs)
            burst_s = time.perf_counter() - t0
            launches[tag] = {"cluster": wrapper.cluster_launches,
                             "stream": wrapper.stream_launches}
            deadline = time.monotonic() + COST_WINDOW_S + 60.0
            while window.state == "tracing" and time.monotonic() < deadline:
                time.sleep(0.1)
            stopped_by_timer = window.stopped_by == "timer"
            res_off = burst(off, reqs)
            snap = on.snapshot()
            health = on._health_payload()
        finally:
            window.stop()
            on.stop()
            off.stop()
        status = np.array([r.status for r in res])
        iters = np.array([r.iters for r in res])
        x = np.stack([r.x for r in res])
        x_off = np.stack([r.x for r in res_off])
        dx = np.abs(x - golden[f"{config}/x"]).max(axis=1)
        eps = params.eps_abs
        budget_err = float(np.abs(x.sum(axis=1) - 1.0).max())
        box = float(max(-x.min(), x.max() - 1.0, 0.0))
        print(f"{tag}: burst of {len(res)} in {burst_s * 1e3:.1f} ms "
              f"({len(res) / burst_s:.1f} solves/s, plane on, profiler "
              f"window open); launches {launches[tag]}; max|dx| "
              f"{float(dx.max()):.3e}", flush=True)
        check(np.array_equal(status, golden[f"{config}/status"])
              and np.array_equal(iters, golden[f"{config}/iters"])
              and bool(np.isfinite(x).all()) and float(dx.max()) <= W_ATOL
              and budget_err <= eps and box <= eps,
              f"[{tag}] {len(res)}/{len(res)} answers equal serve_golden "
              f"(status, iterations, max|dx| {float(dx.max()):.3e} <= "
              f"{W_ATOL:g}, budget and box to eps_abs)")
        check(np.array_equal(x, x_off) and [r.status for r in res_off]
              == status.tolist() and [r.iters for r in res_off]
              == iters.tolist(),
              f"[{tag}] the plane-off service serves the same bits")
        check(launches[tag]["cluster"] > 0 and launches[tag]["stream"] == 0,
              f"[{tag}] the burst launched the cluster form, never the "
              f"streaming one ({launches[tag]})")
        check(snap["compiles"] == n_prewarm and snap["completed"] == len(res)
              and all(s == 0 for s in (snap["failed"], snap["expired"],
                                       snap["rejected"])),
              f"[{tag}] no compile after prewarm, every request completed")
        check(health["cache"].get("cost_records") == len(records)
              and health["cache"].get("cost_write_failures") == 0,
              f"[{tag}] /healthz's cache section carries the cost "
              f"counters ({ {k: health['cache'].get(k) for k in ('cost_records', 'cost_write_failures')} })")
        harvest = sink.buffered()
        profs = [h.get("profile") or {} for h in harvest]
        peak_f, peak_bw = device_peaks(kind)
        check(len(harvest) == len(res) and all(
            pr.get("cost_source") == "torch"
            and pr.get("flops_xla", 0) > 0 and pr.get("bytes_xla", 0) > 0
            for pr in profs),
              f"[{tag}] every harvest record has a profile from the "
              f"entry's CostRecord (cost_source torch)")
        check(peak_f is not None and all(
            "mfu_f32_est" in pr and "mfu_bf16_peak" in pr
            and "hbm_utilization" in pr for pr in profs),
              f"[{tag}] every profile has MFU fields against the card's "
              f"peaks ({kind!r})")
        if profs and "mfu_f32_est" in profs[0]:
            print(f"{tag}: dispatch profile: "
                  f"{ {k: profs[0].get(k) for k in ('seconds', 'batch', 'flops_xla', 'bytes_xla', 'flops_model_ratio', 'bytes_model_ratio', 'achieved_tflops', 'achieved_hbm_gbps', 'mfu_f32_est', 'hbm_utilization', 'roofline_bound', 'peak_bytes')} }",
                  flush=True)
        n_k, dev_us = (_trace_kernels(window.trace_file, kname, kexclude)
                       if window.trace_file else (0, 0.0))
        print(f"{tag}: profiler window {COST_WINDOW_S:g} s, state "
              f"{window.state}, stopped by its timer {stopped_by_timer}, "
              f"error {window.error}; {n_k} {kname} events, "
              f"{dev_us / 1e3:.3f} ms of device time", flush=True)
        check(stopped_by_timer and window.error is None
              and window.trace_file is not None,
              f"[{tag}] the ProfileWindow stopped by its timer and wrote "
              f"its trace")
        check(n_k > 0 and dev_us > 0,
              f"[{tag}] the trace names the kernel {kname} with device "
              f"time")

        # -- the readers ---------------------------------------------------
        stages = profiler.stage_seconds()
        verdict = obs.roofline_verdict(records, stage_seconds=stages,
                                       device_kind=kind)
        ridge = (peak_f / peak_bw) if peak_f else None
        check(len(verdict["ranked"]) == len(records)
              and verdict["ranked"][0].get("stage_seconds")
              and verdict["fusion_candidates"],
              f"[{tag}] roofline_verdict ranks {len(verdict['ranked'])} "
              f"entries joined to the stage seconds; {verdict['verdict']}")
        check(ridge is not None
              and verdict["ridge_flops_per_byte"] == ridge,
              f"[{tag}] roofline_verdict's ridge point "
              f"{verdict['ridge_flops_per_byte']} flop/B is the card's "
              f"peaks'")
        text = obs.render_report(trace=o.spans.chrome_trace(),
                                 events=o.events.events(), snapshot=snap,
                                 harvest=harvest, costs=records)
        sections = text.split("\n" + "-" * 64 + "\n")
        check(len(sections) == 9 and "measured-vs-model" in text
              and f"device cost / memory ({len(records)} CostRecords)"
              in text and f"({len(harvest)} records)" in text,
              f"[{tag}] render_report renders every section "
              f"({len(sections)})")
        ledger_path = os.path.join(tmp, "ledger.jsonl")
        row = obs.ledger_row(
            "serve_loadgen", {"throughput_solves_per_s": len(res) / burst_s,
                        "recompiles_after_warmup": 0, "errors": 0},
            run_id=tag)
        obs.append_row(ledger_path, row)
        rows_back = obs.load_ledger(ledger_path)
        med = obs.rolling_median(rows_back, "throughput_solves_per_s")
        check(rows_back[-1] == json.loads(json.dumps(row))
              and med is not None and med > 0,
              f"[{tag}] a ledger row appended and read back (rolling "
              f"median {med})")
        fleet = _fleet_cell(tag, params, reqs, tmp, device)
        check(fleet["reconciled"] and fleet["fleet"]["completed"] == len(reqs)
              == fleet["fleet"]["harvest_records"]
              == sum(r.get("completed", 0) for r in fleet["rows"])
              and fleet["fleet"]["recompiles_after_warmup"] == 0
              and not fleet["workers_lost"],
              f"[{tag}] two workers on the card reconcile: fleet completed "
              f"{fleet['fleet']['completed']}, harvest "
              f"{fleet['fleet']['harvest_records']}, recompiles "
              f"{fleet['fleet']['recompiles_after_warmup']}")
        print(f"{tag}: {time.perf_counter() - t_run:.1f} s", flush=True)
    check(hashes["cost_trinv"] != hashes["cost_woodbury"],
          "the trinv and woodbury entries have different op hashes")

    added = []
    for key, rname, base, tag in (
            ("cost_k2", "admm_segment[triangular]_cluster, cost plane",
             ("trinv", "cluster"), "cost_trinv"),
            ("cost_k1", "admm_segment_factored_cluster[refine=0], cost plane",
             ("woodbury", "cluster"), "cost_woodbury")):
        params, reqs = calls[tag]
        fn, args, kw = serve_kernel_call(reqs[:STREAM_MAX_BATCH], params, dev)
        kernel_row(rows, key, rname, base, fn, args, kw,
                   launches[tag]["cluster"])
        added.append(key)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return added


def _fleet_cell(tag, params, reqs, tmp, device):
    """Two services on ``device``, each a worker of a FleetCollector
    with its own WorkerStream, serving alternate requests of ``reqs``;
    returns the collector's merged report."""
    from porqua_tpu_torch import obs
    from porqua_tpu_torch.serve import SolveService
    from porqua_tpu_torch.serve.metrics import LATENCY_BUCKETS_S

    collector = obs.FleetCollector(heartbeat_timeout_s=600.0)
    workers = []
    for i in range(2):
        wid = f"w{i}"
        path = os.path.join(tmp, f"{tag}.{wid}.jsonl")
        collector.add_worker(wid, path)
        stream = obs.WorkerStream(path, wid)
        stream.hello(latency_le=LATENCY_BUCKETS_S, worker_idx=i,
                     n_workers=2)
        sink = obs.HarvestSink(None)
        svc = SolveService(params, max_batch=STREAM_MAX_BATCH,
                           max_wait_ms=2.0, warm_start=False, harvest=sink,
                           device=device)
        workers.append((wid, stream, sink, svc))
    try:
        prewarmed = {}
        for wid, stream, sink, svc in workers:
            svc.start()
            prewarmed[wid] = svc.prewarm(reqs[0])
            svc.metrics.reset_window()
        t0 = time.perf_counter()
        tickets = [(workers[i % 2][3], workers[i % 2][3].submit(q))
                   for i, q in enumerate(reqs)]
        for svc, t in tickets:
            svc.result(t, timeout=600)
        measured = time.perf_counter() - t0
        for wid, stream, sink, svc in workers:
            snap = svc.snapshot()
            stream.sample(svc.metrics.slo_sample(),
                          hist=svc.metrics.histograms(),
                          snap={k: snap[k] for k in ("submitted", "batches",
                                                     "compiles")},
                          vitals=svc.vitals())
            stream.report({
                "worker": wid, "completed": snap["completed"],
                "failed": snap["failed"], "expired": snap["expired"],
                "harvest_records": sink.records,
                "recompiles_after_warmup": snap["compiles"],
                "prewarm_compiles": prewarmed[wid],
                "throughput_solves_per_s": snap["completed"] / measured})
        collector.drain()
        report = collector.report()
        print(f"{tag}: fleet of 2 on the card: completed "
              f"{report['fleet']['completed']}, harvest "
              f"{report['fleet']['harvest_records']}, "
              f"{report['fleet']['throughput_solves_per_s']:.1f} solves/s, "
              f"reconciliation {report['reconciliation']}", flush=True)
        return report
    finally:
        for wid, stream, sink, svc in workers:
            svc.stop()
            stream.close()


MESH_ROWS = ("woodbury", "trinv")
SANITIZED_BURST = 256


def mesh_phase(rows, reset_counts, device="cuda"):
    """The mesh, the process group and the transfer guard on the card;
    returns the kernel rows it adds to ``rows``. Checks:
    - ``solve_qp_sharded`` over ``make_mesh()`` on the tracking headline
      batch (252 x 252 x 500, seed 42, f32, eps 1e-3) through K1 at
      refine 0 and through K2: bit-equal to the unsharded
      ``solve_qp_batch`` with the same launches, and status, iterations
      and |dw| <= W_ATOL against phase 4's golden;
    - ``solve_scan_l1_grid(mesh=make_mesh())`` on phase 6's grid (8
      columns, K2): bit-equal to the unsharded grid with the same
      launches, status equal to the golden on every date;
    - ``init_distributed(num_processes=1)`` on NCCL and
      ``make_multihost_mesh()``: a (1, 1) mesh whose solve is bit-equal
      to the unsharded one; the group is destroyed afterwards;
    - under ``PORQUA_SANITIZE=1``: ``solve_batch`` on the tracking batch
      (K1 refine 0), the compacted solve of phase 8's eps 1e-5 batch (K1
      refine 0) and a burst of 256 requests of phase 7's stream through
      ``SolveService`` (K2), each bit-equal to the same run with the
      guard off, and a seeded control in each (a hidden ``.item()`` or a
      CPU operand inside the guarded call) raising ``SanitizerError``;
      the service's control fails its batch and leaves the breaker
      closed;
    - the op-trace contracts (GC101-GC111) on the card with no finding,
      and the op-trace harvest: each program's peak, op count,
      fingerprint and GC20x counts printed."""
    import numpy as np
    import torch

    import porqua_tpu_torch as pt
    import porqua_tpu_torch.qp.solve as solve_mod
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.analysis import sanitize
    from porqua_tpu_torch.compaction import CompactingDriver
    from porqua_tpu_torch.ops import admm_kernel
    from porqua_tpu_torch.parallel import make_mesh, solve_qp_sharded
    from porqua_tpu_torch.parallel.mesh import (init_distributed,
                                                make_multihost_mesh)
    from porqua_tpu_torch.qp.admm import admm_init, segment_kernel_call
    from porqua_tpu_torch.serve import SolveService
    from porqua_tpu_torch.serve.loadgen import build_tracking_requests
    from porqua_tpu_torch.tracking import benchmark_grid_np

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device(device)
    K1, K2 = admm_kernel.admm_segment_factored, admm_kernel.admm_segment
    added = []

    def counts():
        return {name: {"cluster": f.cluster_launches,
                       "stream": f.stream_launches}
                for name, f in (("K1", K1), ("K2", K2))}

    def counted(fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, counts(), (time.perf_counter() - t0) * 1e3

    def first_segment(qp, prm):
        scaled = solve_mod._prepare_impl(qp, prm)[0]
        return segment_kernel_call(admm_init(scaled, prm), scaled, prm)

    @contextlib.contextmanager
    def sanitized(on):
        old = os.environ.get("PORQUA_SANITIZE")
        os.environ["PORQUA_SANITIZE"] = "1" if on else "0"
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("PORQUA_SANITIZE", None)
            else:
                os.environ["PORQUA_SANITIZE"] = old

    @contextlib.contextmanager
    def hidden(kind):
        """The seeded control: the solve's finalize does a hidden host
        read (``item``) or takes a CPU operand (``cpu``)."""
        real = solve_mod._finalize_impl

        def bad(*a, **k):
            sol = real(*a, **k)
            if kind == "item":
                sol.x.sum().item()
                return sol
            return sol._replace(x=sol.x + torch.zeros(sol.x.shape))
        solve_mod._finalize_impl = bad
        try:
            yield
        finally:
            solve_mod._finalize_impl = real

    def raises_sanitizer(fn):
        try:
            fn()
        except sanitize.SanitizerError as exc:
            return str(exc)
        return None

    golden = np.load(os.path.join(here, "porqua_tpu_torch", "testdata",
                                  "tracking_golden.npz"))
    meta = json.loads(str(golden["meta"]))
    Xs_np, ys_np = pt.synthetic_universe_np(
        meta["seed"], meta["n_dates"], meta["window"], meta["n_assets"])
    pt.qp.canonical.HP.apply()
    qp = pt.build_tracking_qp(torch.as_tensor(Xs_np, device=dev),
                              torch.as_tensor(ys_np, device=dev))
    mesh = make_mesh()
    print(f"mesh: {mesh.shape} over {list(mesh.devices.flat)}", flush=True)

    # -- 13a. the sharded solves ---------------------------------------
    prms = {}
    for name in MESH_ROWS:
        p = json.loads(str(golden[f"{name}/params"]))
        prm = prms[name] = pt.SolverParams(**{**p, "backend": "pallas"})
        wrapper = K1 if name == "woodbury" else K2
        ref, c_ref, ms_ref = counted(lambda: pt.solve_qp_batch(qp, prm))
        sh, c_sh, ms_sh = counted(lambda: solve_qp_sharded(qp, mesh, prm))
        tag = "K1" if wrapper is K1 else "K2"
        status = sh.status.cpu().numpy()
        iters = sh.iters.cpu().numpy()
        w = sh.x.cpu().numpy()
        dw = float(np.abs(w - golden[f"{name}/weights"]).max())
        print(f"sharded [{name}]: {ms_sh:.1f} ms (unsharded "
              f"{ms_ref:.1f} ms); launches {c_sh[tag]} (unsharded "
              f"{c_ref[tag]}); solved {int((status == 1).sum())}/"
              f"{len(status)}; max|dw| vs golden {dw:.3e}", flush=True)
        check(same_bits(sh, ref), f"[sharded {name}] bit-equal to the "
              "unsharded solve_qp_batch on the same batch")
        check(c_sh == c_ref and c_sh[tag]["cluster"] > 0
              and c_sh[tag]["stream"] == 0,
              f"[sharded {name}] the same launches as the unsharded solve, "
              f"through the {tag} cluster form ({c_sh[tag]})")
        check(np.array_equal(status, golden[f"{name}/status"])
              and np.array_equal(iters, golden[f"{name}/iters"])
              and bool(np.isfinite(w).all()) and dw <= W_ATOL,
              f"[sharded {name}] status and iterations equal phase 4's "
              f"golden on every date, max|dw| {dw:.3e} <= {W_ATOL:g}")
        fn, args, kw = first_segment(qp, prm)
        check(fn is wrapper, f"[sharded {name}] its segment is {tag}")
        key = (f"mesh_{name}", "cluster")
        kernel_row(rows, key, f"{rows[(name, 'cluster')]['name']}@mesh",
                   (name, "cluster"), fn, args, kw, c_sh[tag]["cluster"])
        added.append(key)
        if name == "trinv":
            ref_trinv = ref

    # -- 13b. the grid through the mesh --------------------------------
    sg = np.load(os.path.join(here, SCAN_PATH))
    smeta = json.loads(str(sg["meta"]))
    T, n, B, tc = (smeta["n_dates"], smeta["n_assets"], smeta["n_columns"],
                   smeta["tc"])
    Xg_np, yg_np = pt.synthetic_universe_np(smeta["seed"], T,
                                            smeta["window"], n)
    Xg = torch.as_tensor(Xg_np, device=dev)
    cols = [pt.build_tracking_qp(Xg, torch.as_tensor(y, device=dev))
            for y in benchmark_grid_np(Xg_np, yg_np, B)]
    grid = pt.CanonicalQP(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*cols)))
    del cols
    prm_g = pt.SolverParams(**{**json.loads(str(sg["scan_l1_grid/params"])),
                               "backend": "pallas"})
    w_grid = np.tile(np.full(n, 1.0 / n, np.float32), (B, 1))
    fixed = pt.FIXED_UNIVERSE
    g_ref, c_gref, ms_gref = counted(lambda: pt.solve_scan_l1_grid(
        grid, n, w_grid, tc, prm_g, universes=fixed))
    g_sh, c_gsh, ms_gsh = counted(lambda: pt.solve_scan_l1_grid(
        grid, n, w_grid, tc, prm_g, mesh=mesh, universes=fixed))
    g_status = g_sh.status.cpu().numpy()
    g_x = g_sh.x.cpu().numpy()
    print(f"grid through the mesh: {ms_gsh:.1f} ms for {T} dates x {B} "
          f"columns (unsharded {ms_gref:.1f} ms); launches {c_gsh['K2']} "
          f"(unsharded {c_gref['K2']})", flush=True)
    check(same_bits(g_sh, g_ref), "[grid mesh] bit-equal to the unsharded "
          "solve_scan_l1_grid")
    check(c_gsh == c_gref and c_gsh["K2"]["cluster"] > 0
          and c_gsh["K2"]["stream"] == 0 and c_gsh["K1"]["cluster"] == 0,
          f"[grid mesh] the same launches, through the K2 cluster form "
          f"({c_gsh['K2']})")
    check(np.array_equal(g_status, sg["scan_l1_grid/status"])
          and bool(np.isfinite(g_x).all())
          and g_x.shape == sg["scan_l1_grid/x"].shape,
          "[grid mesh] status equals phase 6's golden on every date, "
          "weights finite, of its shape")
    l1w = tbatch._l1_weight(n, n, tc, torch.float32, dev)
    fn, args, kw = scan_kernel_call(grid, torch.as_tensor(w_grid, device=dev),
                                    l1w, prm_g, 2)
    kernel_row(rows, ("mesh_grid", "cluster"),
               "admm_segment[triangular]_cluster@grid,mesh",
               ("trinv", "cluster"), fn, args, kw, c_gsh["K2"]["cluster"])
    added.append(("mesh_grid", "cluster"))
    del grid, g_ref, g_sh

    # -- 13c. the one-process NCCL group -------------------------------
    import torch.distributed as dist

    world = init_distributed(num_processes=1)
    try:
        hm = make_multihost_mesh()
        nc, c_nc, ms_nc = counted(
            lambda: solve_qp_sharded(qp, hm, prms["trinv"]))
        print(f"nccl: world {world}, backend {dist.get_backend()}, mesh "
              f"{hm.shape} {hm.axis_names}; solve {ms_nc:.1f} ms, launches "
              f"{c_nc['K2']}", flush=True)
        check(world == 1 and dist.get_backend() == "nccl"
              and hm.shape == (1, 1) and hm.axis_names == ("hosts", "dates"),
              "[nccl] init_distributed(num_processes=1) gives a world of 1 "
              "on nccl and make_multihost_mesh() a (1, 1) hosts x dates mesh")
        check(same_bits(nc, ref_trinv), "[nccl] the solve through the "
              "multihost mesh is bit-equal to the unsharded one")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "[nccl] the group is destroyed")

    # -- 13d. the sanitized runs ---------------------------------------
    problems = tbatch.BatchProblems(
        qp=qp.to("cpu"), rebdates=[str(i) for i in range(qp.q.shape[0])],
        universes=[[]] * qp.q.shape[0], n_assets_max=meta["n_assets"])
    prm = prms["woodbury"]
    with sanitized(False):
        bare, c_bare, _ = counted(lambda: tbatch.solve_batch(problems, prm))
    with sanitized(True):
        guarded, c_guard, ms_guard = counted(
            lambda: tbatch.solve_batch(problems, prm))
        with hidden("item"):
            ctl = raises_sanitizer(lambda: tbatch.solve_batch(problems, prm))
    print(f"sanitized solve_batch [woodbury]: {ms_guard:.1f} ms, launches "
          f"{c_guard['K1']}; control: {ctl}", flush=True)
    check(same_bits(guarded, bare) and c_guard == c_bare,
          "[sanitized solve_batch] bit-equal to the unguarded run, with the "
          "same launches")
    check(ctl is not None, "[sanitized solve_batch] a hidden .item() in the "
          "guarded solve raises SanitizerError")

    sec = np.load(os.path.join(here, SECONDARY_PATH))
    prm_c = pt.SolverParams(**{**json.loads(str(sec["compact_woodbury/params"])),
                               "backend": "pallas"})
    driver = CompactingDriver(prm_c)
    driver.prewarm(qp.q.shape[0], qp.n, qp.m, dtype=qp.q.dtype,
                   factor_rows=qp.Pf.shape[-2])
    with sanitized(False):
        (c_off, _), c_coff, _ = counted(lambda: driver.solve(qp))
    with sanitized(True):
        (c_on, rep), c_con, ms_con = counted(lambda: driver.solve(qp))
        with hidden("cpu"):
            ctl_c = raises_sanitizer(lambda: driver.solve(qp))
    print(f"sanitized compaction [compact_woodbury, eps 1e-5]: {ms_con:.1f} "
          f"ms, launches {c_con['K1']}, dispatch widths "
          f"{sorted(set(rep.dispatch_sizes))[:8]}...; control: {ctl_c}",
          flush=True)
    check(same_bits(c_on, c_off) and c_con == c_coff
          and c_con["K1"]["cluster"] > 0,
          "[sanitized compaction] bit-equal to the unguarded compacted "
          "solve, with the same K1 launches")
    check(ctl_c is not None, "[sanitized compaction] a CPU operand in the "
          "guarded finalize raises SanitizerError")
    fn, args, kw = first_segment(qp, prm_c)
    kernel_row(rows, ("sanitized_compact", "cluster"),
               f"{rows[('woodbury', 'cluster')]['name']}@sanitized,compacted",
               ("woodbury", "cluster"), fn, args, kw,
               c_con["K1"]["cluster"])
    added.append(("sanitized_compact", "cluster"))
    del driver, problems

    sv = np.load(os.path.join(here, SERVE_PATH))
    smeta = json.loads(str(sv["meta"]))
    prm_s = pt.SolverParams(**{**json.loads(str(sv["trinv/params"])),
                               "backend": "pallas"})
    reqs = build_tracking_requests(SANITIZED_BURST, smeta["n_assets"],
                                   smeta["window"], smeta["seed"], False)
    # One batch of the whole burst: the size trigger, never the age one.
    svc = SolveService(prm_s, max_batch=SANITIZED_BURST, max_wait_ms=60000.0,
                       warm_start=False, device=device)

    def burst():
        tickets = [svc.submit(q) for q in reqs]
        out = []
        for t in tickets:
            try:
                out.append(svc.result(t, timeout=600))
            except Exception as exc:  # noqa: BLE001 - the control's
                out.append(exc)
        return out

    svc.start()
    try:
        sanitize.reset()
        svc.prewarm(reqs[0])
        with sanitized(False):
            off, c_soff, _ = counted(burst)
        with sanitized(True):
            on, c_son, ms_son = counted(burst)
            with hidden("item"):
                bad = burst()
        snap = svc.snapshot()
    finally:
        svc.stop()
    same = all(not isinstance(a, Exception) and not isinstance(b, Exception)
               and np.array_equal(a.x, b.x) and a.status == b.status
               and a.iters == b.iters for a, b in zip(on, off))
    failed = sum(isinstance(r, Exception) and "sanitizer" in str(r)
                 for r in bad)
    print(f"sanitized serve [trinv, burst of {len(reqs)}]: {ms_son:.1f} ms, "
          f"launches {c_son['K2']}; control: {failed}/{len(bad)} requests "
          f"failed by the sanitizer; breaker: degraded {snap['degraded']}, "
          f"switches {snap['device_switches']}, dispatch failures "
          f"{snap['dispatch_failures']}", flush=True)
    check(same and c_son == c_soff and c_son["K2"]["cluster"] > 0,
          "[sanitized serve] every answer bit-equal to the unguarded burst, "
          "with the same K2 launches")
    check(failed == len(bad) and not snap["degraded"]
          and snap["device_switches"] == 0
          and snap["dispatch_failures"] == 0,
          "[sanitized serve] the control (a hidden .item() in the guarded "
          "dispatch) fails its batch with SanitizerError and leaves the "
          "breaker closed")
    fn, args, kw = serve_kernel_call(reqs, prm_s, dev)
    kernel_row(rows, ("sanitized_serve", "cluster"),
               f"{rows[('trinv', 'cluster')]['name']}@sanitized,serve",
               ("trinv", "cluster"), fn, args, kw, c_son["K2"]["cluster"])
    added.append(("sanitized_serve", "cluster"))

    # -- 13e. contracts and the op-trace harvest on the card -----------
    from porqua_tpu_torch.analysis import contracts, hlo
    from porqua_tpu_torch.qp.canonical import stack_qps
    from porqua_tpu_torch.serve.bucketing import BucketLadder

    t0 = time.perf_counter()
    found = contracts.check_entry_points(device=device)
    print(f"contracts on {device}: {len(found)} finding(s) in "
          f"{time.perf_counter() - t0:.1f} s"
          + "".join(f"\n  {f.format()}" for f in found), flush=True)
    check(not found, "[contracts] GC101-GC111 clean on the card")
    t0 = time.perf_counter()
    progs = hlo.harvest_entry_points(device=device)
    # The serving entry at the stream's bucket (256 x 512 x 8, K2): the
    # fusion misses (GC201) at a production shape.
    qp_b = stack_qps([BucketLadder().pad(q)[1] for q in reqs]).to(dev)
    progs.append(hlo.lower_program(
        "serve_entry[256x512x8]",
        lambda q, x, y: solve_mod._solve_impl(q, prm_s, x, y),
        (qp_b, torch.zeros_like(qp_b.q), torch.zeros_like(qp_b.l))))
    lint = hlo.lint_harvest(progs, include_padding=False)
    by = {}
    for f in lint:
        prog = hlo.hlolint.path_program(f.path)
        by.setdefault(prog, {}).setdefault(f.rule, 0)
        by[prog][f.rule] += 1
    print(f"op-trace harvest on {device}: {len(progs)} programs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for hp in progs:
        print(f"  {hp.label}: peak {hp.peak_bytes:.0f} B, {hp.n_ops} ops, "
              f"flops {hp.flops:.4g}, bytes {hp.bytes_accessed:.4g}, "
              f"launches {hp.record.get('kernel_launches')}, fingerprint "
              f"{hp.fingerprint}, findings {by.get(hp.label, {})}",
              flush=True)
    big = progs[-1].parse()
    ranked = [f for f in lint if f.rule == "GC201"
              and f.path == hlo.hlolint.hlo_path(progs[-1].label)]
    print(f"GC201 ranking, serve_entry[256x512x8] ({len(ranked)} "
          f"finding(s), widest first):", flush=True)
    for f in ranked[:10]:
        print(f"  line {f.line}: {f.message}", flush=True)
    base = hlo.load_baseline()
    check(set(base["programs"]) <= {hp.label for hp in progs} and all(
        hp.peak_bytes is not None and hp.peak_bytes > 0 for hp in progs)
        and any(i.op.startswith("kernel:") for i in big.ops),
        f"[harvest] every program of the baseline recorded on the card "
        f"with a measured peak, the serving entry through its kernel "
        f"({len(progs)} programs)")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return added


# Phase 14 runs the port's examples (porqua_tpu_torch/examples/, the
# twins of the JAX package's examples/*.py) through their ``main`` on
# the card at the JAX examples' own sizes, against the JAX goldens
# (XLA-CPU; scripts/torch_examples_golden.py writes EXAMPLES_PATH;
# backtest_usa's configuration 1 is BT_PATH's usa_trinv run). The
# examples run backend "auto", as the JAX examples do: that reaches no
# Pallas call there and no hand kernel here, so every wrapper's launch
# counter must stay at 0. The rules, by quantity (an earlier phase's
# where it holds the same one):
# - status and iterations equal the golden's wherever an example
#   reports them;
# - weights of an f64 run whose optimum is a point (24 assets under a
#   252-day window): |dw| <= W_ATOL;
# - backtest_usa configuration 1 (f32, its optimum a face, ROADMAP
#   section C): status and iterations equal, the weights per date by
#   the twin rule against BT_PATH's f64 run (KERNEL_VS_PLAIN times
#   XLA-CPU's f32 distance plus ULPS_PER_ITER f32 ulps of the box per
#   iteration); configuration 2 (f64, phase 6's rule): every date
#   solved, serial and scan weights within USA_W_ATOL;
# - scalars of f64 runs (cumulative returns, tracking errors, net
#   values, Sharpe ratios, turnover) within EX_F64_ATOL, relative to
#   max(1, |golden|); quickstart's per-date turnover on the dates whose
#   previous weights hold no negative entry in either run (a weight
#   that is zero to rounding, -1e-24 in one run, sends the reference's
#   drift through its long/short rescaling and moves that date by a
#   whole unit; kept for parity);
# - gradients of the f64 tuning examples within EX_GRAD_RTOL of the
#   golden's, and at the end point against central differences of the
#   port's own objective within EX_FD_RTOL (net_sharpe_tuning's own
#   check);
# - the cross-solver table by phase 9's COMPARE_OBJ / COMPARE_HOST;
# - lstm_selection from the golden's draws (the JAX run's initial
#   parameters, minibatch order and dropout masks): losses and held-out
#   predictions by the twin rule against the same training in f64
#   (KERNEL_VS_PLAIN times XLA-CPU's f32 distance plus ULPS_PER_ITER
#   f32 ulps of the scale per Adam step), the top-10 names printed;
# - ordinal fits: cutpoints within ML_OPT_ATOL and the NLL within
#   ML_NLL_ATOL (phase 12's rule); the coefficient through the NLL
#   only: the example's one feature (a monthly return, scale 0.05)
#   leaves the NLL flat in it (2.5e-6 over beta in [-0.063, -0.002]),
#   and f32 fits stop anywhere on that stretch (XLA-CPU's probit fit
#   at -0.062, its logit fit at -0.0015, the f64 optimum about -0.06
#   for both; the port's probit fit at -0.0025 on the CPU and the card);
# - OLS/PCA fits within ML_OPT_ATOL (phase 12), the rank labels and
#   the top asset equal; ml_prediction's boosting step is a
#   host sklearn estimator and sklearn is not installed beside the
#   card, so the phase runs it with boosting=False (the CPU tests hold
#   the boosting step).
EXAMPLES_PATH = os.path.join("porqua_tpu_torch", "testdata",
                             "examples_golden.npz")
EX_F64_ATOL = 1e-6
EX_GRAD_RTOL = 1e-4
EX_FD_RTOL = 1e-3


def turnover_held(got, want, atol):
    """quickstart's per-date turnover of each strategy against the
    golden's within ``atol`` (relative to max(1, |golden|)), on the dates
    whose previous weights hold no negative entry in either run (the
    rule above); returns (passed, dates held, dates left out)."""
    import numpy as np

    ok, held, out = True, 0, 0
    for name in ("qeqw", "ls", "wls", "lad"):
        if got[f"{name}/weights"].shape != want[f"{name}/weights"].shape:
            return False, 0, 0
        neg = np.minimum(got[f"{name}/weights"],
                         want[f"{name}/weights"]).min(axis=1) < 0
        for d, (a, b) in enumerate(zip(got[f"{name}/turnover_series"],
                                       want[f"{name}/turnover_series"])):
            if d > 0 and neg[d - 1]:
                out += 1
                continue
            ok &= bool(abs(a - b) <= atol * max(1.0, abs(b)))
            held += 1
    return ok, held, out


def central_difference(fn, x, h):
    """(fn(x + h) - fn(x - h)) / 2h of a scalar function of a float."""
    return (fn(x + h) - fn(x - h)) / (2 * h)


def examples_phase(reset_counts, device="cuda"):
    """Phase 14: the port's examples on ``device`` against the JAX
    goldens, by the rules at EXAMPLES_PATH. Prints each example's own
    output, its time and the kernel wrappers' launches; returns the
    seconds per example."""
    import importlib
    import importlib.util

    import numpy as np
    import torch

    from porqua_tpu_torch.examples import EXAMPLES
    from porqua_tpu_torch.examples._common import unpack_golden
    from porqua_tpu_torch.ops import admm_kernel

    dev = torch.device(device)
    here = os.path.dirname(os.path.abspath(__file__))
    arrays = np.load(os.path.join(here, EXAMPLES_PATH))
    meta = json.loads(str(arrays["meta"]))
    print(f"phase 14: golden from commit {meta['commit']} ({meta['command']})",
          flush=True)
    usa = np.load(os.path.join(here, BT_PATH))
    wrappers = (admm_kernel.admm_segment, admm_kernel.admm_segment_factored)
    seconds = {}

    def run(name, **kw):
        module = importlib.import_module(f"porqua_tpu_torch.examples.{name}")
        reset_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = module.main(device, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in wrappers}
        print(f"[{name}] {seconds[name]:.2f} s on {device}; kernel "
              f"launches {launches}", flush=True)
        check(not any(launches.values()), f"[{name}] backend 'auto' "
              f"launched no hand kernel, as the JAX example reaches no "
              f"Pallas call")
        return out, unpack_golden(arrays, f"{name}/full")

    def near(tag, got, want, atol=EX_F64_ATOL):
        got, want = np.asarray(got, float), np.asarray(want, float)
        same = got.shape == want.shape
        err = float(np.abs(got - want).max()) if same and got.size else 0.0
        bound = atol * max(1.0, float(np.abs(want).max()))
        ok = same and bool(np.isfinite(got).all()) and err <= bound
        check(ok, f"{tag} within {bound:.3g} of the golden (max |d| "
              f"{err:.3e})")

    def equal(tag, got, want):
        check(np.array_equal(np.asarray(got), np.asarray(want)),
              f"{tag} equal to the golden")

    def grads(tag, got, want, rtol=EX_GRAD_RTOL):
        got, want = np.asarray(got, float), np.asarray(want, float)
        same = got.shape == want.shape
        rel = float(np.max(np.abs(got - want) / np.maximum(
            np.abs(want), 1e-300))) if same else float("inf")
        check(same and rel <= rtol,
              f"{tag} within {rtol:g} relative of the golden's (max "
              f"{rel:.3e})")

    # -- quickstart ----------------------------------------------------------
    out, ref = run("quickstart")
    check(out["rebdates"] == ref["rebdates"], "[quickstart] the golden's dates")
    for name in ("qeqw", "ls", "wls", "lad", "batched"):
        near(f"[quickstart] {name} weights", out[f"{name}/weights"],
             ref[f"{name}/weights"], W_ATOL)
    for k in [k for k in ref if k.endswith("/cum") or k.startswith(
            "percentile/") or k == "batched/drift"]:
        near(f"[quickstart] {k}", out[k], ref[k])
    ok, held, left = turnover_held(out, ref, EX_F64_ATOL)
    check(ok and held >= 4, f"[quickstart] per-date turnover on {held} "
          f"strategy-dates ({left} left out by the rule)")

    # -- index_replication ------------------------------------------------------
    out, ref = run("index_replication")
    for k in ("status", "iters"):
        equal(f"[index_replication] {k}", out[k], ref[k])
    near("[index_replication] weights", out["weights"], ref["weights"],
         W_ATOL)
    for k in ("tracking_error", "cum", "cum_bm"):
        near(f"[index_replication] {k}", out[k], ref[k])

    # -- backtest_usa --------------------------------------------------------------
    out, ref = run("backtest_usa")
    for k in ("status", "iters"):
        equal(f"[backtest_usa config 1] {k}", out[f"config1/{k}"],
              usa[f"usa_trinv/{k}"])
    floor = (ULPS_PER_ITER * int(usa["usa_trinv/iters"].max()) * F32_EPS
             * 0.05)
    w64 = usa["usa_trinv/weights_f64"]
    d_card = np.abs(out["config1/weights"] - w64).max(axis=1)
    d_gold = np.abs(usa["usa_trinv/weights"] - w64).max(axis=1)
    check(bool(np.all(d_card <= KERNEL_VS_PLAIN * d_gold + floor)),
          f"[backtest_usa config 1] weights per date within "
          f"{KERNEL_VS_PLAIN:g}x XLA-CPU's f32 distance to the f64 run "
          f"(+{floor:.2g}; max {d_card.max():.3e}, golden's "
          f"{d_gold.max():.3e})")
    print(f"[backtest_usa config 1] Sharpe {out['config1/sharpe']:.6f} "
          f"(golden {ref['config1/sharpe']:.6f}), tracking error "
          f"{out['config1/tracking_error']:.6e} (golden "
          f"{ref['config1/tracking_error']:.6e})", flush=True)
    equal("[backtest_usa config 2] universe", out["config2/universe"],
          ref["config2/universe"])
    check(bool((out["config2/status"] == 1).all()),
          "[backtest_usa config 2] every date solved")
    for k in ("serial_weights", "scan_weights"):
        near(f"[backtest_usa config 2] {k}", out[f"config2/{k}"],
             ref[f"config2/{k}"], USA_W_ATOL)
    print(f"[backtest_usa config 2] max |dw| serial-vs-scan "
          f"{out['config2/max_dw']:.3e} (golden {ref['config2/max_dw']:.3e});"
          f" realized turnover median {out['config2/realized_median']:.6f} "
          f"(golden {ref['config2/realized_median']:.6f})", flush=True)

    # -- compare_solver -------------------------------------------------------------
    out, ref = run("compare_solver")
    df = out["table"]
    check(list(df.index) == ref["rows"]
          and bool(df["solution_found"].astype(bool).all()),
          "[compare_solver] the golden's rows, every one found")
    ipm = float(df.loc["ipm-f64", "objective_value"])
    for row in df.index:
        obj = float(df.loc[row, "objective_value"])
        check(abs(obj - ipm) <= COMPARE_OBJ * max(1.0, abs(ipm)),
              f"[compare_solver] {row} objective within {COMPARE_OBJ:g} "
              f"of ipm-f64's ({obj:.10e})")
    for row in ("ipm-f64", "native-cpp-admm", "scipy-slsqp"):
        i = ref["rows"].index(row)
        for col in ("objective_value", "primal_residual", "dual_residual",
                    "duality_gap"):
            got, want = float(df.loc[row, col]), float(ref[f"table/{col}"][i])
            ok = (np.isnan(got) if np.isnan(want) else
                  abs(got - want) <= COMPARE_HOST * max(1.0, abs(want)))
            check(ok, f"[compare_solver] {row} {col} within {COMPARE_HOST:g}"
                  f" of the golden's ({got:.6e}, golden {want:.6e})")

    # -- cost_aware_backtest ------------------------------------------------------------
    out, ref = run("cost_aware_backtest")
    for k in ("status_native", "iters_native", "status_chain", "iters_chain"):
        equal(f"[cost_aware_backtest] {k}", out[k], ref[k])
    for k in ("w_lift", "w_native", "x_chain"):
        near(f"[cost_aware_backtest] {k}", out[k], ref[k], W_ATOL)
    for k in ("chain_turnover", "static_turnover"):
        near(f"[cost_aware_backtest] {k}", out[k], ref[k])
    check(out["dgrid"] <= W_ATOL, f"[cost_aware_backtest] the grid through "
          f"the mesh ({out['n_dev']} slot(s)) within {W_ATOL:g} of the "
          f"single chain ({out['dgrid']:.3e})")
    check(out["dw_checkpoint"] == 0.0 and out["resume"]["resumed_chunks"]
          == out["resume"]["total_chunks"] == ref["resume"]["total_chunks"],
          "[cost_aware_backtest] the resumed run reads every chunk back, "
          "bit-identical")

    # -- differentiable_tuning ------------------------------------------------------------
    from porqua_tpu_torch.examples import differentiable_tuning as dt

    out, ref = run("differentiable_tuning")
    grads("[differentiable_tuning] gradient per step", out["grads"],
          ref["grads"])
    near("[differentiable_tuning] log-ridge path", out["path"], ref["path"])
    for k in ("te_start", "te_tuned", "grid_te"):
        near(f"[differentiable_tuning] {k}", out[k], ref[k])
    oos_te = dt.objective(dev)

    def te_of(x):
        with torch.no_grad():
            return float(oos_te(torch.tensor(x, dtype=torch.float64,
                                             device=dev)))

    fd = central_difference(te_of, out["log_ridge"], 1e-4)
    print(f"[differentiable_tuning] at the tuned log-ridge "
          f"{out['log_ridge']:.6f}: last gradient {out['grads'][-1]:+.6e}, "
          f"central difference there {fd:+.6e}", flush=True)
    th = torch.tensor(out["log_ridge"], dtype=torch.float64, device=dev,
                      requires_grad=True)
    oos_te(th).backward()
    g_end = float(th.grad)
    check(abs(g_end - fd) <= EX_FD_RTOL * abs(fd),
          f"[differentiable_tuning] gradient at the tuned point "
          f"{g_end:+.6e} within {EX_FD_RTOL:g} of central differences")

    # -- cost_penalty_tuning ---------------------------------------------------------------
    from porqua_tpu_torch.examples import cost_penalty_tuning as cp

    out, ref = run("cost_penalty_tuning")
    grads("[cost_penalty_tuning] gradient per step", out["grads"],
          ref["grads"])
    grads("[cost_penalty_tuning] lifted and native gradients at 1e-3.2",
          [out["g_lift"], out["g_native"]], [ref["g_lift"], ref["g_native"]])
    for k in ("path", "values", "start", "net_tuned", "best_log", "grid_net"):
        near(f"[cost_penalty_tuning] {k}", out[k], ref[k])
    net_loss = cp.objectives(dev)[0]

    def net_of(x):
        with torch.no_grad():
            return float(net_loss(torch.tensor(x, dtype=torch.float64,
                                               device=dev)))

    fd = central_difference(net_of, -3.2, 1e-4)
    check(abs(out["g_lift"] - fd) <= EX_FD_RTOL * abs(fd),
          f"[cost_penalty_tuning] lifted gradient at 1e-3.2 "
          f"{out['g_lift']:+.6e} within {EX_FD_RTOL:g} of central "
          f"differences ({fd:+.6e})")

    # -- net_sharpe_tuning ------------------------------------------------------------------
    out, ref = run("net_sharpe_tuning")
    grads("[net_sharpe_tuning] dS/dtheta per iteration", out["grad"],
          ref["grad"])
    for k in ("lambda", "sharpe", "turnover", "sharpe_final", "sharpe_zero",
              "sharpe_frozen", "lambda_final"):
        near(f"[net_sharpe_tuning] {k}", out[k], ref[k])
    grads("[net_sharpe_tuning] dS/dlambda at the end point",
          out["grad_final"], ref["grad_final"])
    check(abs(out["grad_final"] - out["fd_final"])
          <= EX_FD_RTOL * abs(out["fd_final"]),
          f"[net_sharpe_tuning] the example's FD check: gradient "
          f"{out['grad_final']:+.6f} within {EX_FD_RTOL:g} of central "
          f"differences ({out['fd_final']:+.6f})")

    # -- ordinal_regression -------------------------------------------------------------------
    out, ref = run("ordinal_regression")
    for distr in ("probit", "logit"):
        near(f"[ordinal_regression] {distr} cutpoints",
             out[f"{distr}/cutpoints"], ref[f"{distr}/cutpoints"],
             ML_OPT_ATOL)
        near(f"[ordinal_regression] {distr} NLL", out[f"{distr}/nll"],
             ref[f"{distr}/nll"], ML_NLL_ATOL)
        print(f"[ordinal_regression] {distr} beta {out[f'{distr}/beta']} "
              f"(golden {ref[f'{distr}/beta']}, held through the NLL)",
              flush=True)
        print(f"[ordinal_regression] {distr} accuracy train / test "
              f"{out[f'{distr}/acc_train']:.4f} / {out[f'{distr}/acc_test']:.4f}"
              f" (golden {ref[f'{distr}/acc_train']:.4f} / "
              f"{ref[f'{distr}/acc_test']:.4f})", flush=True)

    # -- lstm_selection -------------------------------------------------------------------------
    lstm_ref = unpack_golden(arrays, "lstm_selection/full")
    draws = {"init_params": tree_of(arrays, "lstm_selection/full/draws/"
                                            "init_params/"),
             "batch_indices": lstm_ref["draws/batch_indices"].astype(
                 np.int64),
             "dropout_masks": lstm_ref["draws/dropout_masks"]}
    out, ref = run("lstm_selection", draws=draws)
    steps = draws["batch_indices"].shape[0]
    for key in ("loss", "pred"):
        g64 = lstm_ref[f"{key}_f64"]
        ok, d, band = twin_rule(np.asarray(out[key])[None], ref[key][None],
                                g64[None], floor=ULPS_PER_ITER * steps
                                * F32_EPS * float(np.abs(g64).max()))
        check(bool(ok.all()), f"[lstm_selection] {key} by the twin rule "
              f"against the f64 training ({float(d.max()):.3e} against a "
              f"band of {float(band.max()):.3e}; XLA-CPU's f32 "
              f"{float(np.abs(ref[key] - g64).max()):.3e})")
    print(f"[lstm_selection] top-10 {out['top10']} (golden {ref['top10']}); "
          f"RMSE {out['rmse']:.6e} (golden {ref['rmse']:.6e}); NDCG "
          f"{out['ndcg']:.6f} (golden {ref['ndcg']:.6f})", flush=True)

    # -- ml_prediction -----------------------------------------------------------------------------
    boosting = importlib.util.find_spec("sklearn") is not None
    if not boosting:
        print("[ml_prediction] sklearn is not installed here: the example "
              "runs with boosting=False (the CPU tests hold the boosting "
              "step)", flush=True)
    out, ref = run("ml_prediction", boosting=boosting)
    for k in ("evr", "OLS/coef", "OLS/pred", "PCA+OLS/pred", "OLS/rmse",
              "PCA+OLS/rmse"):
        near(f"[ml_prediction] {k}", out[k], ref[k], ML_OPT_ATOL)
    equal("[ml_prediction] rank labels", out["labels"], ref["labels"])
    check(out["top"] == ref["top"], f"[ml_prediction] last month's top "
          f"asset {out['top']} is the golden's")

    missing = sorted(set(EXAMPLES) - set(seconds))
    check(not missing, f"phase 14 ran every example (missing: {missing})")
    print(f"phase 14: {sum(seconds.values()):.1f} s in the examples: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()),
          flush=True)
    return seconds


def shadow_rule(lanes, golden, check_interval):
    """SHADOW rule over ``lanes`` = ``(request, loser, status, iters)``:
    every lane's status equals the golden's answer on that loser; its
    iterations equal the golden's, or (the f32 floor: a residual check
    landing on the other side of eps) differ by one check interval, on
    at most SHADOW_OFF_SHARE of the lanes. Returns ``(ok, report)``."""
    import numpy as np

    if not lanes:
        return False, "no shadow lanes"
    st_eq = [int(golden[m][0][i]) == s for i, m, s, _ in lanes]
    d = np.array([abs(int(golden[m][1][i]) - it) for i, m, _, it in lanes])
    off = int((d > 0).sum())
    ok = (all(st_eq) and bool((d <= check_interval).all())
          and off <= SHADOW_OFF_SHARE * len(lanes))
    return ok, (f"{len(lanes)} lanes: status equal on {sum(st_eq)}, "
                f"iterations equal on {len(lanes) - off}, max|diters| "
                f"{int(d.max())}")


def profile_run(run, label, top=10):
    """One run under torch.profiler: wall time, the device's busy time
    (the sum of its kernels' and copies' own times) and idle share, and
    the ``top`` device entries by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # The porqua/<stage> ranges are annotations, not device work.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("porqua/")]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.2f})", flush=True)
    for e in events[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)


def cluster_shape(dense, args, kw):
    """(shared bytes per block, resident clusters) of the cluster form
    at this call's shape."""
    from porqua_tpu_torch.ops import admm_kernel

    if dense:
        lib = admm_kernel._library(admm_kernel._DENSE_LIB)
        shape = (args[0].shape[-1], args[1].shape[-2], int(kw["triangular"]))
        return (lib.porqua_admm_dense_cluster_smem_bytes(*shape),
                lib.porqua_admm_dense_cluster_max_active(*shape))
    lib = admm_kernel._library(admm_kernel._CLUSTER_LIB)
    B, k, n = args[0].shape
    shape = (n, args[6].shape[-2], k, kw["refine_steps"])
    return (lib.porqua_admm_cluster_smem_bytes(*shape),
            lib.porqua_admm_cluster_max_active(*shape))


def stream_shape(dense, args, kw):
    """(shared bytes per block, None) of the streaming form (a single
    block per problem) at this call's shape."""
    from porqua_tpu_torch.ops import admm_kernel

    lib = admm_kernel._library(admm_kernel._LIB)
    if dense:
        return lib.porqua_admm_segment_smem_bytes(
            0, args[0].shape[-1], args[1].shape[-2], 0), None
    B, k, n = args[0].shape
    return lib.porqua_admm_segment_smem_bytes(1, n, args[6].shape[-2],
                                              k), None


def global_shape(dense, args, kw):
    """(shared bytes per block, resident clusters) of the factored
    device-memory form at this call's shape."""
    from porqua_tpu_torch.ops import admm_kernel

    lib = admm_kernel._library(admm_kernel._CLUSTER_LIB)
    B, k, n = args[0].shape
    shape = (n, args[6].shape[-2], k, kw["refine_steps"])
    return (lib.porqua_admm_cluster_global_smem_bytes(*shape),
            lib.porqua_admm_cluster_global_max_active(*shape))


def tail_shape(dense, args, kw):
    """(shared bytes per block, resident clusters) of the dense cluster
    with a streamed tail at this call's shape."""
    from porqua_tpu_torch.ops import admm_kernel

    lib = admm_kernel._library(admm_kernel._DENSE_LIB)
    shape = (args[0].shape[-1], args[1].shape[-2], int(kw["triangular"]))
    return (lib.porqua_admm_dense_tail_smem_bytes(*shape),
            lib.porqua_admm_dense_tail_max_active(*shape))


def dense_layout(args, kw, form):
    """What a dense cluster form keeps where at this call's shape: its
    rank count, and per block the operator bytes resident in shared
    memory and (the tail) those streamed on every iteration."""
    from porqua_tpu_torch.ops import admm_kernel

    lib = admm_kernel._library(admm_kernel._DENSE_LIB)
    n, m, tri = args[0].shape[-1], args[1].shape[-2], int(kw["triangular"])
    if form == "tail":
        ranks, rows = 16, lib.porqua_admm_dense_tail_rows(n, m, tri)
    else:
        ranks, rows = lib.porqua_admm_dense_cluster_ranks(n, m, tri), n
    nc = -(-n // ranks)
    ld = (nc + 3) // 4 * 4
    if tri:
        resident = 4 * (nc * n - ranks * nc * (nc - 1) // 2)
    else:
        resident = 4 * rows * ld
    return (f"{ranks} ranks; operator per block {resident} B resident, "
            f"{4 * (n - rows) * nc} B streamed per iteration ({rows} of "
            f"{n} rows resident)")


SHAPE_OF = {"cluster": cluster_shape, "stream": stream_shape,
            "global": global_shape, "tail": tail_shape}


def form_of(dense, args, kw):
    """The form the router picks for this kernel call."""
    from porqua_tpu_torch.ops import admm_kernel

    if dense:
        return admm_kernel.dense_form(args[0].shape[-1], args[1].shape[-2],
                                      kw["triangular"])
    B, k, n = args[0].shape
    return admm_kernel.factored_form(n, args[6].shape[-2], k,
                                     kw["refine_steps"])


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import porqua_tpu_torch as pt
    from porqua_tpu_torch.ops import _build, admm_kernel
    from porqua_tpu_torch.qp.admm import admm_init, segment_kernel_call
    from porqua_tpu_torch.qp.solve import _prepare_impl

    # -- 1. card ---------------------------------------------------------
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = admm_kernel.LIBRARIES
    _build.build(*libs)
    for lib in libs:
        admm_kernel._library(lib)
    print(f"build: {', '.join(lib + '.cu' for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        info = _build.build_info[lib]
        print(f"build {lib}.cu: nvcc {info['seconds']:.1f} s\n"
              f"{info['log'].strip()}", flush=True)
    for lib in (admm_kernel._CLUSTER_LIB, admm_kernel._DENSE_LIB):
        for ln in ptxas_lines(_build.build_info[lib]["log"]):
            print(f"ptxas [{lib}.cu]: {ln}", flush=True)

    golden = np.load(os.path.join(os.path.dirname(pt.__file__), "testdata",
                                  "tracking_golden.npz"))
    meta = json.loads(str(golden["meta"]))
    Xs_np, ys_np = pt.synthetic_universe_np(
        meta["seed"], meta["n_dates"], meta["window"], meta["n_assets"])
    dev = torch.device("cuda")
    Xs = torch.as_tensor(Xs_np, device=dev)
    ys = torch.as_tensor(ys_np, device=dev)
    names = ["woodbury", "woodbury_refine1", "trinv", "inverse"]
    params = {}
    for name in names:
        p = json.loads(str(golden[f"{name}/params"]))
        p["backend"] = "pallas"
        params[name] = pt.SolverParams(**p)
    # Kernel rows: (config, form).
    kernel_rows = [("woodbury", "cluster"), ("woodbury_refine1", "cluster"),
                   ("woodbury", "stream"), ("woodbury_refine1", "stream"),
                   ("trinv", "stream"), ("trinv", "cluster"),
                   ("inverse", "stream"), ("inverse", "cluster")]
    dense_kind = {"trinv": "triangular", "inverse": "inverse"}

    def row_name(name, form):
        if name in dense_kind:
            return f"admm_segment[{dense_kind[name]}]_{form}"
        refine = params[name].woodbury_refine
        return f"admm_segment_factored_{form}[refine={refine}]"

    def source(name, form):
        if form == "stream":
            return "porqua_tpu_torch/csrc/admm_segment.cu"
        lib = (admm_kernel._DENSE_LIB if name in dense_kind
               else admm_kernel._CLUSTER_LIB)
        return f"porqua_tpu_torch/csrc/{lib}.cu"

    plain = {admm_kernel.admm_segment: admm_kernel.admm_segment_ref,
             admm_kernel.admm_segment_factored:
                 admm_kernel.admm_segment_factored_ref}
    named = {admm_kernel.admm_segment: admm_kernel._admm_segment_form,
             admm_kernel.admm_segment_factored:
                 admm_kernel._admm_segment_factored_form}

    # -- 3. each kernel against its plain twin ---------------------------
    pt.qp.canonical.HP.apply()
    rows = {}
    for name in names:
        prm = params[name]
        qp = pt.build_tracking_qp(Xs, ys)
        scaled = _prepare_impl(qp, prm)[0]
        carry = admm_init(scaled, prm)
        fn, args, kw = segment_kernel_call(carry, scaled, prm)
        # The function's answer on these inputs, to f32 rounding, and
        # the twin's f32 noise over its summation orders.
        ref = twin_reference(plain[fn], args, kw)
        plain_ms = cuda_ms(lambda: plain[fn](*args, **kw), 1, 5)
        forms = ("stream", "cluster")
        launch = {f: (lambda kw=kw, f=f: named[fn](f, *args, **kw))
                  for f in forms}
        for form in forms:
            out_k = launch[form]()
            torch.cuda.synchronize()
            rname = row_name(name, form)
            print(f"kernel {rname} against its plain twin:", flush=True)
            ok, err, rel, floor = check_twin(out_k, ref, kw)
            flops, nbytes = admm_kernel.launch_cost(rname, args, kw)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
            rows[(name, form)] = {
                "name": rname,
                "route": "cuda",
                "source": source(name, form),
                "replaces": ("porqua_tpu/ops/admm_kernel.py:340"
                             if name.startswith("woodbury")
                             else "porqua_tpu/ops/admm_kernel.py:251"),
                "launches": 0,
                "max_abs_err": err,
                "ms": None,
                "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }
            print(f"  B={args[-1].shape[0]} n_iters={kw['n_iters']} "
                  f"max_abs_err={err:.3e} max_rel_err={rel:.3e}; bound "
                  f"{rows[(name, form)]['bound_ms']:.4f} ms "
                  f"({rows[(name, form)]['bound_by']}; {flops:.4g} flop, "
                  f"{nbytes:.4g} B)", flush=True)
            check(ok, f"{rname} agrees with its plain twin: per output "
                  f"|kernel-f64| <= {KERNEL_VS_PLAIN:g} noise + "
                  f"{floor:.3g} scale")
        # Times in turns: each form first and last in turn (stream,
        # cluster, cluster, stream), median of all its single launches.
        turns = forms + forms[::-1]
        samples = {f: [] for f in forms}
        for f in turns:
            samples[f] += cuda_times(launch[f], 2, 10)
        for form in forms:
            row = rows[(name, form)]
            row["ms"] = statistics.median(samples[form])
            moved = admm_kernel.launch_traffic(row["name"], args, kw, form)
            print(f"time {row['name']}: kernel {row['ms']:.4f} ms "
                  f"(turn medians "
                  f"{statistics.median(samples[form][:10]):.4f}, "
                  f"{statistics.median(samples[form][10:]):.4f}), plain "
                  f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms; "
                  f"design moves {moved / 1e9:.4f} GB per launch "
                  f"({moved / row['ms'] / 1e9:.1f} TB/s)", flush=True)
            if form == "cluster":
                smem, active = cluster_shape(name in dense_kind, args, kw)
                print(f"  {row['name']}: {smem} B of shared memory per "
                      f"block; {active} clusters resident at once for "
                      f"{args[-1].shape[0]} problems", flush=True)
            # Set-up (operator load) against the iterations: the same
            # launch with one iteration.
            one = cuda_ms(lambda: launch[form](dict(kw, n_iters=1)), 2, 10)
            per_iter = (row["ms"] - one) / (kw["n_iters"] - 1)
            print(f"  {row['name']}: 1 iteration {one:.4f} ms; "
                  f"{per_iter * 1e3:.2f} us per further iteration "
                  f"for the batch", flush=True)

    # -- 3b. every form at the ragged widths, the device-memory forms at
    # the gap shapes -------------------------------------------------------
    t0 = time.perf_counter()
    ragged_twin_checks()
    kernel_rows += gap_rows(rows)
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 4. the main path ------------------------------------------------
    wrappers = (admm_kernel.admm_segment, admm_kernel.admm_segment_factored)

    def reset_counts():
        for f in wrappers:
            f.launches = f.cluster_launches = f.stream_launches = 0
            f.widths = {}
        admm_kernel.admm_segment_factored.global_launches = 0
        admm_kernel.admm_segment.tail_launches = 0

    def timed(prm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.tracking_step(Xs_np, ys_np, prm)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    for name in names:
        prm = params[name]
        times = []
        wrapper = (admm_kernel.admm_segment if name in dense_kind
                   else admm_kernel.admm_segment_factored)
        for _ in range(2):   # the first run includes the library warm-up
            reset_counts()
            res, ms = timed(prm)
            launches = {"cluster": wrapper.cluster_launches,
                        "stream": wrapper.stream_launches}
            times.append(ms)
        for form, count in launches.items():
            rows[(name, form)]["launches"] = count
        # The same solve on the plain per-iteration path, for comparison.
        plain_prm = dataclasses.replace(prm, backend="xla")
        plain_ms = min(timed(plain_prm)[1] for _ in range(2))
        status = res.status.cpu().numpy()
        iters = res.iters.cpu().numpy()
        te = res.tracking_error.cpu().numpy()
        w = res.weights.cpu().numpy()
        g_w = golden[f"{name}/weights"]
        dw = float(np.abs(w - g_w).max())
        te_rel = abs(float(np.median(te)) - float(np.median(
            golden[f"{name}/tracking_error"]))) / float(np.median(
                golden[f"{name}/tracking_error"]))
        print(f"main path [{name}]: {times[1]:.1f} ms end to end "
              f"(first run {times[0]:.1f} ms; plain path {plain_ms:.1f} ms)"
              f"; launches {launches}; "
              f"solved {int((status == 1).sum())}/{len(status)}; iters "
              f"{sorted(set(iters.tolist()))}; median TE "
              f"{float(np.median(te)):.6e}; max|dw| vs golden {dw:.3e}; "
              f"TE rel diff {te_rel:.3e}", flush=True)
        check(launches["cluster"] > 0, f"[{name}] the main path launched "
              f"{row_name(name, 'cluster')}")
        check(launches["stream"] == 0, f"[{name}] the main path never "
              f"launched {row_name(name, 'stream')}")
        check(bool(np.isfinite(w).all()) and w.shape == g_w.shape,
              f"[{name}] weights finite, shape {w.shape}")
        check(np.array_equal(status, golden[f"{name}/status"]),
              f"[{name}] status equals the JAX golden on every date")
        check(np.array_equal(iters, golden[f"{name}/iters"]),
              f"[{name}] iterations equal the JAX golden on every date")
        check(dw <= W_ATOL, f"[{name}] max|dw| {dw:.3e} <= {W_ATOL:g}")
        check(te_rel <= TE_RTOL,
              f"[{name}] median TE within {TE_RTOL:g} relative")

    # -- 5. the backtest -------------------------------------------------
    kernel_rows += backtest_phase(rows, reset_counts)

    # -- where the time goes: one profiled headline run --------------------
    profile_run(lambda: pt.tracking_step(Xs_np, ys_np, params["woodbury"]),
                "profile [woodbury]")

    # -- 6. the date-chained backtests -----------------------------------
    del Xs, ys
    kernel_rows += scan_phases(rows, reset_counts)
    turnover_phase(reset_counts)

    # -- 7. serving ------------------------------------------------------
    added, bare_bursts = serve_phase(rows, reset_counts)
    kernel_rows += added

    # -- 8. secondary configurations ---------------------------------------
    kernel_rows += secondary_phase(rows, reset_counts)

    # -- 9. the differentiable solve -----------------------------------------
    kernel_rows += diff_phase(rows, reset_counts)

    # -- 10. the routed, retried and observed service ----------------------
    kernel_rows += routed_serve_phase(rows, reset_counts,
                                      bare_bursts=bare_bursts)

    # -- 11. the device-cost plane -----------------------------------------
    kernel_rows += cost_phase(rows, reset_counts)

    # -- 12. the ML selection models ---------------------------------------
    kernel_rows += ml_phase(rows, reset_counts)

    # -- 13. the mesh, the process group and the transfer guard ------------
    kernel_rows += mesh_phase(rows, reset_counts)

    # -- 14. the examples ------------------------------------------------------
    t0 = time.perf_counter()
    examples_phase(reset_counts)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- report ----------------------------------------------------------
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [rows[r] for r in kernel_rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
