#!/usr/bin/env python3
"""What one dispatch of the phase-10 blend's tenants costs, by size.

    PYTHONPATH=. python3 scripts/torch_blend_probe.py [--device cuda]
        [--turnover-assets 15 24]

Takes the three-tenant blend of ``chip_smoke.py``'s phase 10 (its spec
in ``porqua_tpu_torch/testdata/route_golden.npz``), and for the
turnover tenant at each size of ``--turnover-assets`` (and the tracking
and LAD tenants at their blend sizes) builds the tenant's pool
(``serve/workloads.py::build_problems``), pads it into its bucket and
solves it as one batch through the service's compiled entry
(``ExecutableCache``) on the backend the blend routes the tenant to and
on ADMM (``backend="pallas"``: K2 on the card). Prints per row the
bucket, the slots, the iterations, the entry's build (warm-up) seconds
and the solve's seconds around a synchronize. Needs the card unless
``--device cpu``.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import porqua_tpu_torch as pt  # noqa: E402
from porqua_tpu_torch.qp.canonical import stack_qps  # noqa: E402
from porqua_tpu_torch.qp.solve import resolve_device  # noqa: E402
from porqua_tpu_torch.serve import workloads  # noqa: E402

ROUTE = os.path.join(ROOT, "porqua_tpu_torch", "testdata",
                     "route_golden.npz")
SERVE = os.path.join(ROOT, "porqua_tpu_torch", "testdata",
                     "serve_golden.npz")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def solve_pool(pool, params, dev):
    """(bucket, slots, iterations, build s, solve s) of ``pool`` as one
    batch through a fresh cache's compiled entry."""
    ladder = pt.serve.BucketLadder()
    bucket = ladder.select(pool[0])
    slots = pt.serve.bucketing.slot_count(len(pool), len(pool))
    cache = pt.serve.ExecutableCache(params)
    t0 = time.perf_counter()
    entry = cache.get(bucket, slots, torch.float32, dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    qp = stack_qps([ladder.pad(q)[1] for q in pool])
    x0 = torch.zeros((slots, bucket.n), dtype=qp.q.dtype)
    y0 = torch.zeros((slots, bucket.m), dtype=qp.q.dtype)
    t0 = time.perf_counter()
    sol = entry(qp, x0, y0)
    sync(dev)
    solve_s = time.perf_counter() - t0
    return (f"{bucket.n}x{bucket.m}", slots,
            sorted(set(sol.iters.cpu().tolist())), build_s, solve_s)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--turnover-assets", type=int, nargs="+",
                    default=[15, 24])
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    rmeta = json.loads(str(np.load(ROUTE)["meta"]))
    base = json.loads(str(np.load(SERVE)["trinv/params"]))
    params = pt.SolverParams(**{**base, "backend": "pallas"})
    bl = rmeta["blend"]
    specs = {s.name: s for s in workloads.parse_tenant_specs(bl["spec"])}
    rows = [(name, spec) for name, spec in specs.items()
            if spec.problem != "turnover"]
    for name, spec in specs.items():
        if spec.problem == "turnover":
            rows += [(name, dataclasses.replace(spec, n_assets=n))
                     for n in args.turnover_assets]
    for name, spec in rows:
        pool = workloads.build_problems(spec, seed=bl["seed"])
        for method in sorted({bl["routes"][name], "admm"}):
            bucket, slots, iters, build_s, solve_s = solve_pool(
                pool, dataclasses.replace(params, method=method), dev)
            print(json.dumps(dict(
                tenant=name, problem=spec.problem, n_assets=spec.n_assets,
                bucket=bucket, method=method, slots=slots, iters=iters,
                build_s=build_s, solve_s=solve_s)), flush=True)


if __name__ == "__main__":
    main()
