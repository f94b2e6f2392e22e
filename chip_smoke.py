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
   cluster form, and the time of a launch with one iteration.
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
8. One JSON line per kernel, then the card line, then the result line.
"""

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
# most KERNEL_VS_PLAIN times the f32 plain version's own distance, plus
# ULPS_PER_ITER f32 ulps of the output's scale (the state vector it
# belongs to) for every iteration of the segment.
KERNEL_VS_PLAIN = 4.0
ULPS_PER_ITER = 2
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


def work(name, args, kw):
    """(flops, bytes) the kernel's function needs for this call: every
    matvec of every iteration, each input read once (L^-1: its lower
    triangle, V and Dv only when refining), each output written once.
    Elementwise updates (~30 flops per entry) are left out: under 1%."""
    if name.startswith("admm_segment_factored"):
        W, inv_d, Y0, Ginv, V, Dv, C = args[:7]
        B, k, n = W.shape
        m = C.shape[-2]
        r = kw["refine_steps"]
        per_iter = 4 * k * n * (1 + 2 * r) + 2 * m * n * 3 + 2 * m * m + 2 * n * m
        inputs = [a for i, a in enumerate(args) if r or i not in (4, 5)]
        nbytes = sum(a.numel() for a in inputs) * 4
    else:
        op, C = args[:2]
        B, n, _ = op.shape
        m = C.shape[-2]
        if kw["triangular"]:
            per_iter = 2 * n * (n + 1) + 4 * m * n
            op_bytes = B * n * (n + 1) // 2 * 4
        else:
            per_iter = 2 * n * n + 4 * m * n
            op_bytes = op.numel() * 4
        nbytes = op_bytes + sum(a.numel() for a in args[1:]) * 4
    nbytes += B * (5 * n + 3 * m) * 4     # x z w y mu dx dy dmu
    return B * kw["n_iters"] * per_iter, nbytes


def traffic(name, args, kw):
    """Device-memory bytes a kernel design moves per launch, from its
    access pattern: the streaming forms read their operator on every
    iteration (W twice, V twice more per refinement round, L^-1's lower
    triangle twice, K^-1 once); the cluster forms read each input once.
    All write each output once."""
    once = work(name, args, kw)[1]
    if "_cluster" in name:
        return once
    op = args[0]
    if name.startswith("admm_segment_factored"):
        r = kw["refine_steps"]
        per_iter = (2 + 4 * r) * op.numel() * 4
        counted = op.numel() * 4 * (1 + (r > 0))     # W (and V) once
        return once + kw["n_iters"] * per_iter - counted
    B, n, _ = op.shape
    op_bytes = (B * n * (n + 1) // 2 * 4 if kw["triangular"]
                else op.numel() * 4)
    reads = 2 if kw["triangular"] else 1
    return once + (reads * kw["n_iters"] - 1) * op_bytes


def ptxas_lines(log):
    """ptxas' lines on each kernel's registers, shared memory and
    spills, each group after the line that names its kernel."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def check_twin(out_k, out_p, out_64, kw, out_cpu=None):
    """The kernel against its plain twin by the rule above; returns
    (passed, max |kernel - plain|, max relative). With ``out_cpu`` (the
    same twin run on the CPU) the twin's distance to float64 is the
    larger of its runs on the card and on the CPU: on the small duals
    one f32 run of the twin can land far nearer the float64 answer than
    rounding warrants (PERF.md section 6), as the dense cluster tests of
    tests/test_torch_cuda.py also allow."""
    import torch

    errs, rels, ok = [], [], True
    floor = ULPS_PER_ITER * kw["n_iters"] * F32_EPS
    for i, (a, b, c) in enumerate(zip(out_k, out_p, out_64)):
        scale = float(out_64[SCALE_OF[i]].abs().max())
        err = float((a - b).abs().max())
        e_k = float((a.double() - c).abs().max())
        e_p = float((b.double() - c).abs().max())
        note = f"|plain-f64| {e_p:.3e}"
        if out_cpu is not None:
            e_cpu = float((out_cpu[i].double() - c.cpu()).abs().max())
            note += f"  |cpu plain-f64| {e_cpu:.3e}"
            e_p = max(e_p, e_cpu)
        ok &= bool(torch.isfinite(a).all()) and (
            e_k <= KERNEL_VS_PLAIN * e_p + floor * scale)
        errs.append(err)
        rels.append(err / scale if scale > 0 else err)
        print(f"  {OUT_NAMES[i]:>3}: |kernel-plain| {err:.3e}  "
              f"|kernel-f64| {e_k:.3e}  {note}  scale {scale:.3e}")
    return ok, max(errs), max(rels), floor


def usa_service(X, bm, rebdates, meta):
    """``examples/backtest_usa.py``'s configuration 1 (budget and box,
    LeastSquares) as a BacktestService of the port."""
    import porqua_tpu_torch as pt
    from porqua_tpu_torch import builders as tb

    O = pt.OptimizationItemBuilder
    return pt.BacktestService(
        data={"return_series": X, "bm_series": bm},
        selection_item_builders={
            "data": pt.SelectionItemBuilder(bibfn=tb.bibfn_selection_data)},
        optimization_item_builders={
            "returns": O(bibfn=tb.bibfn_return_series, width=meta["width"]),
            "bm": O(bibfn=tb.bibfn_bm_series, width=meta["width"],
                    align=True),
            "budget": O(bibfn=tb.bibfn_budget_constraint),
            "box": O(bibfn=tb.bibfn_box_constraints, upper=meta["upper"])},
        optimization=pt.LeastSquares(),
        settings={"rebdates": rebdates, "quiet": True})


def backtest_phase(rows, reset_counts):
    """The backtest on the card for both configs; returns the kernel
    rows it adds to ``rows`` (keyed like the tracking rows).

    Checks, per config, over all 55 dates:
    - status and iterations equal the golden on every date;
    - the config's kernel went through the form its shape chooses
      (``dense_form`` / ``factored_form``) and never the other;
    - weights finite, of the golden's shape, inside the budget and the
      box to eps_abs;
    - the card's ADMM iterate (the same run with polish off) by the
      twin rule above against the f64 iterate, on every date; where the
      card's polish was rejected its weights are that iterate;
    - each date's in-sample tracking error at most KERNEL_VS_PLAIN times
      the golden's.
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
        return (strategy.get_weights_df().reindex(columns=X.columns)
                .to_numpy(float))

    # The in-sample objective ||X w - y||^2 per date, in f64 on the host.
    obj_qp = tbatch.build_problems(service(), dtype=torch.float64).qp

    def in_sample_te(w):
        val = obj_qp.objective_value(torch.tensor(w)).numpy()
        return np.sqrt(np.maximum(val, 0.0) / meta["width"])

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
            d_gold = np.abs(g_iter - ref64).max(axis=1)
            d_card = np.abs(w0 - ref64).max(axis=1)
            floor = ULPS_PER_ITER * int(iters.max()) * F32_EPS * meta["upper"]
            te_card, te_gold = in_sample_te(w), in_sample_te(g_w)
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
            check(np.array_equal(status, golden[f"{name}/status"]),
                  f"[{name}] status equals the JAX golden on every date")
            check(np.array_equal(iters, golden[f"{name}/iters"]),
                  f"[{name}] iterations equal the JAX golden on every date")
            ok_shape = bool(np.isfinite(w).all()) and w.shape == g_w.shape
            check(ok_shape and float(np.abs(w.sum(1) - 1).max()) <= prm.eps_abs
                  and float(w.min()) >= -prm.eps_abs
                  and float(w.max()) <= meta["upper"] + prm.eps_abs,
                  f"[{name}] weights finite, shape {w.shape}, budget and "
                  f"box hold to {prm.eps_abs:g}")
            check(bool(np.all(d_card <= KERNEL_VS_PLAIN * d_gold + floor)),
                  f"[{name}] ADMM iterate per date within "
                  f"{KERNEL_VS_PLAIN:g}x the golden's distance to the f64 "
                  f"iterate (+{floor:.2g})")
            check(bool(np.all(te_card <= KERNEL_VS_PLAIN * te_gold)),
                  f"[{name}] in-sample TE per date within "
                  f"{KERNEL_VS_PLAIN:g}x the golden's")

            # The segment kernel at this shape against its plain twin.
            scaled = tsolve._prepare_impl(qp_dev, prm)[0]
            fn, args, kw = segment_kernel_call(admm_init(scaled, prm),
                                               scaled, prm)
            plain = (admm_kernel.admm_segment_ref if dense
                     else admm_kernel.admm_segment_factored_ref)
            out_k = fn(*args, **kw)
            out_p = plain(*args, **kw)
            out_64 = plain(*(a.double() for a in args), **kw)
            out_cpu = plain(*(a.cpu() for a in args), **kw)
            base = rows[(ref_row, "cluster")]["name"]
            rname = f"{base}@usa"
            print(f"kernel {rname} against its plain twin (its distance "
                  f"the larger of its runs on the card and the CPU):",
                  flush=True)
            ok, err, rel, tfloor = check_twin(out_k, out_p, out_64, kw,
                                              out_cpu)
            check(ok, f"{rname} agrees with its plain twin: per output "
                  f"|kernel-f64| <= {KERNEL_VS_PLAIN:g} |plain-f64| + "
                  f"{tfloor:.3g} scale")
            flops, nbytes = work(rname, args, kw)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
            ms = statistics.median(cuda_times(lambda: fn(*args, **kw), 2, 20))
            plain_ms = cuda_ms(lambda: plain(*args, **kw), 1, 5)
            moved = traffic(rname, args, kw)
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


def kernel_row(rows, key, rname, base, fn, args, kw, launches):
    """Hold one kernel call against its plain twin (its distance the
    larger of its runs on the card and the CPU), time it and its twin,
    and add its row to ``rows`` under ``key``."""
    import torch

    from porqua_tpu_torch.ops import admm_kernel

    plain = (admm_kernel.admm_segment_ref if fn is admm_kernel.admm_segment
             else admm_kernel.admm_segment_factored_ref)
    out_k = fn(*args, **kw)
    torch.cuda.synchronize()
    out_p = plain(*args, **kw)
    out_64 = plain(*(a.double() for a in args), **kw)
    out_cpu = plain(*(a.cpu() for a in args), **kw)
    print(f"kernel {rname} against its plain twin (its distance the larger "
          f"of its runs on the card and the CPU):", flush=True)
    ok, err, rel, tfloor = check_twin(out_k, out_p, out_64, kw, out_cpu)
    check(ok, f"{rname} agrees with its plain twin: per output |kernel-f64| "
          f"<= {KERNEL_VS_PLAIN:g} |plain-f64| + {tfloor:.3g} scale")
    flops, nbytes = work(rname, args, kw)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    ms = statistics.median(cuda_times(lambda: fn(*args, **kw), 2, 20))
    plain_ms = cuda_ms(lambda: plain(*args, **kw), 1, 5)
    moved = traffic(rname, args, kw)
    dense = fn is admm_kernel.admm_segment
    smem, active = cluster_shape(dense, args, kw)
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
          f"{flops:.4g} flop, {nbytes:.4g} B); design moves "
          f"{moved / 1e9:.4f} GB per launch; {smem} B of shared memory per "
          f"block, {active} clusters resident at once; max_abs_err "
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
    kernel rows it adds to ``rows``. Three runs of the reference
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
    launches, calls = {}, {}

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
    return added


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
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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


def main():
    import torch

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
        out_p = plain[fn](*args, **kw)
        # The function's answer on these inputs, to f32 rounding.
        out_64 = plain[fn](*(a.double() for a in args), **kw)
        plain_ms = cuda_ms(lambda: plain[fn](*args, **kw), 1, 5)
        forms = ("stream", "cluster")
        launch = {f: (lambda kw=kw, f=f: named[fn](f, *args, **kw))
                  for f in forms}
        for form in forms:
            out_k = launch[form]()
            torch.cuda.synchronize()
            rname = row_name(name, form)
            print(f"kernel {rname} against its plain twin:", flush=True)
            ok, err, rel, floor = check_twin(out_k, out_p, out_64, kw)
            flops, nbytes = work(rname, args, kw)
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
                  f"|kernel-f64| <= {KERNEL_VS_PLAIN:g} |plain-f64| + "
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
            moved = traffic(row["name"], args, kw)
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

    # -- 4. the main path ------------------------------------------------
    wrappers = (admm_kernel.admm_segment, admm_kernel.admm_segment_factored)

    def reset_counts():
        for f in wrappers:
            f.launches = f.cluster_launches = f.stream_launches = 0

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
    kernel_rows += serve_phase(rows, reset_counts)

    # -- 8. report -------------------------------------------------------
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
