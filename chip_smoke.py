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
6. One JSON line per kernel, then the card line, then the result line.
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
    from porqua_tpu_torch import builders as tb
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
        return pt.BacktestService(
            data={"return_series": X, "bm_series": bm},
            selection_item_builders={
                "data": pt.SelectionItemBuilder(
                    bibfn=tb.bibfn_selection_data)},
            optimization_item_builders={
                "returns": pt.OptimizationItemBuilder(
                    bibfn=tb.bibfn_return_series, width=meta["width"]),
                "bm": pt.OptimizationItemBuilder(
                    bibfn=tb.bibfn_bm_series, width=meta["width"],
                    align=True),
                "budget": pt.OptimizationItemBuilder(
                    bibfn=tb.bibfn_budget_constraint),
                "box": pt.OptimizationItemBuilder(
                    bibfn=tb.bibfn_box_constraints, upper=meta["upper"])},
            optimization=pt.LeastSquares(),
            settings={"rebdates": rebdates, "quiet": True})

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

    # -- 6. report -------------------------------------------------------
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
