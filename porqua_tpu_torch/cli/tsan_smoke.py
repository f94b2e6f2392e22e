"""TSAN loadgen smoke: the lock-order sanitizer under real contention.

Runs a short closed-loop load-generation pass (the same
:func:`porqua_tpu_torch.serve.loadgen.run_loadgen` harness the serving
load generator uses) with ``PORQUA_TSAN=1`` forced on, so every
instrumented lock in the serve stack — WarmStartCache,
ExecutableCache, DeviceHealth, RetryManager, ServeMetrics, EventBus,
SpanRecorder — runs with per-thread held-lock sets, the runtime
acquisition-order graph, the hold-time budget, and the deadlock
watchdog live while caller threads, the batcher dispatch loop, the
retry timer wheel, and future callbacks all contend. A retry policy
and a hedge are enabled on purpose (they add the timer thread and its
callbacks to the mix).

Exit status: 0 when the pass completes with zero errors, zero
recompiles after warmup, and zero sanitizer violations recorded;
1 otherwise (an order inversion / hold breach / deadlock raises into
the serving path AND is re-checked here via ``tsan.violations()``).

Static GC008-GC010 (``cli.run_checks``) prove the discipline on
source, this proves it on the live interleaving.

Usage:
    python -m porqua_tpu_torch.cli.tsan_smoke [--requests N] [--assets N] [--json] [--device D]
"""

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tsan_smoke",
        description="PORQUA_TSAN=1 serve loadgen smoke")
    parser.add_argument("--requests", type=int, default=192)
    parser.add_argument("--assets", type=int, default=16)
    parser.add_argument("--window", type=int, default=64)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON")
    parser.add_argument("--device", default=None,
                        help="device the service runs on (default: the "
                             "card)")
    args = parser.parse_args(argv)

    # The sanitizer reads the variable when each lock is built: set it
    # before the service (and every lock in it) exists, and put the old
    # value back on the way out, since a caller may run this in-process.
    old = os.environ.get("PORQUA_TSAN")
    os.environ["PORQUA_TSAN"] = "1"
    try:
        return _run(args)
    finally:
        if old is None:
            os.environ.pop("PORQUA_TSAN", None)
        else:
            os.environ["PORQUA_TSAN"] = old


def _run(args) -> int:
    from porqua_tpu_torch.analysis import tsan
    from porqua_tpu_torch.resilience.retry import RetryPolicy
    from porqua_tpu_torch.serve.loadgen import (
        SERVE_PARAMS,
        build_tracking_requests,
        run_loadgen,
    )

    tsan.reset()
    requests = build_tracking_requests(
        args.requests, n_assets=args.assets, window=args.window)
    report = run_loadgen(
        requests, params=SERVE_PARAMS, mode="closed",
        max_batch=args.max_batch, max_wait_ms=1.0, warm_keys=True,
        retry=RetryPolicy(max_attempts=2, hedge_after_s=0.25),
        device=args.device)

    graph = tsan.order_graph()
    edges = sum(len(v) for v in graph.values())
    summary = {
        "requests": args.requests,
        "throughput_solves_per_s": round(
            report["throughput_solves_per_s"], 1),
        "errors": report["errors"],
        "recompiles_after_warmup": report["recompiles_after_warmup"],
        "lock_order_nodes": len(graph),
        "lock_order_edges": edges,
        "tsan_violations": tsan.violations(),
    }
    if args.json:
        print(json.dumps({**report, "tsan": summary}, indent=2))
    else:
        print("tsan_smoke: "
              f"{summary['throughput_solves_per_s']} solves/s, "
              f"{summary['errors']} errors, "
              f"{summary['recompiles_after_warmup']} recompiles, "
              f"order graph {len(graph)} nodes / {edges} edges, "
              f"{len(summary['tsan_violations'])} violations")
        for v in summary["tsan_violations"]:
            print(f"  VIOLATION: {v}")

    ok = (report["errors"] == 0
          and report["recompiles_after_warmup"] == 0
          and not summary["tsan_violations"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
