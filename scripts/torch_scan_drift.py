#!/usr/bin/env python3
"""How far the chained L1 scans drift from their f64 twin, by path: the
numbers behind chip_smoke.py's chain twin rule, PERF.md section 6 and
ROADMAP section C.

    PYTHONPATH=. python scripts/torch_scan_drift.py [--device cuda] \
        [--seeds 42 7] [--cpu] [--out chiprun_out/scan_drift.json]

For each seed, chip_smoke.py's scan inputs (the 500-asset universe over
64 dates, a 252-day window, tc 0.002; ``synthetic_universe_np(seed)``)
and its two chains with the params of the committed golden
(``porqua_tpu_torch/testdata/scan_golden.npz``): ``scan_l1`` (woodbury,
refine 0: the factored kernel at one lane) and ``scan_l1_grid`` (8
benchmark columns, trinv: the triangular-inverse kernel at 8 lanes).
Each chain runs

- in f64 on the plain path on ``--device`` (the twin every distance is
  taken to; trinv for the grid, as in f32);
- in f32 through the kernels (``backend="pallas"``), twice (the second
  run shows whether the kernel path repeats bit for bit);
- in f32 on the plain path (``backend="xla"``) on ``--device``;
- with ``--cpu``, in f32 on the plain path on the CPU;

and for the golden's seed also the golden's f32 chain (XLA-CPU) and its
f64 chain. Per path and lane it prints the largest distance over the
dates to the f64 chain, the date of it and the first date past 1e-4,
and per lane the ratio of the kernel path's distance to the largest of
the other f32 paths' (the chain twin rule's ratio).

With ``--usa``, also ``examples/backtest_usa.py`` configuration 2 (f64,
eps 1e-8; chip_smoke.py's ``usa_turnover``) through
``solve_scan_turnover`` on ``--device`` and, with ``--cpu``, on the CPU:
per path the largest max|dw| to the golden's chain (XLA-CPU), its date,
and the dates with the golden's iterations. Imports no JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import porqua_tpu_torch as pt  # noqa: E402
from porqua_tpu_torch.tracking import benchmark_grid_np  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(pt.__file__), "testdata",
                      "scan_golden.npz")


def problems(seed, meta, device, dtype):
    """The single column and the grid, on ``device`` in ``dtype``."""
    Xs, ys = pt.synthetic_universe_np(seed, meta["n_dates"], meta["window"],
                                      meta["n_assets"])
    Ys = benchmark_grid_np(Xs, ys, meta["n_columns"])
    X = torch.as_tensor(Xs.astype(dtype), device=device)
    cols = [pt.build_tracking_qp(X, torch.as_tensor(y.astype(dtype),
                                                    device=device))
            for y in Ys]
    grid = pt.CanonicalQP(*(None if f[0] is None else torch.stack(f)
                            for f in zip(*cols)))
    return cols[0], grid


def chain(kind, qp, meta, prm, device):
    """The chain's weights as ``(lanes, T, n)`` float64 numpy, with its
    status and iterations."""
    n, tc = meta["n_assets"], meta["tc"]
    w = np.full(n, 1.0 / n)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if kind == "scan_l1":
        sol = pt.solve_scan_l1(qp, n, w, tc, prm, universes=pt.FIXED_UNIVERSE,
                               device=device)
        sol = pt.QPSolution(*(None if f is None else f[None] for f in sol))
    else:
        sol = pt.solve_scan_l1_grid(qp, n, np.tile(w, (qp.q.shape[0], 1)),
                                    tc, prm, universes=pt.FIXED_UNIVERSE,
                                    device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return dict(x=sol.x.double().cpu().numpy(), status=sol.status.cpu()
                .numpy(), iters=sol.iters.cpu().numpy(), ms=ms)


def distance(x, x64):
    """Per lane: the largest max|x - x64| over the dates, its date, and
    the first date past 1e-4 (None if none)."""
    d = np.abs(x - x64).max(axis=-1)
    past = [int(np.argmax(row > 1e-4)) if (row > 1e-4).any() else None
            for row in d]
    return dict(max=d.max(axis=-1).tolist(), at=d.argmax(axis=-1).tolist(),
                first_past_1e4=past)


def usa_turnover(golden, device, cpu):
    """Configuration 2's chain on ``device`` (and the CPU) against the
    golden's."""
    import chip_smoke

    _, problems, w_init, _ = chip_smoke.usa_turnover_inputs(golden)
    n = len(problems.universes[0])
    prm = pt.SolverParams(**json.loads(str(golden["usa_turnover/params"])))
    g_x, g_it = golden["usa_turnover/x"][:, :n], golden["usa_turnover/iters"]
    out = {}
    for dev in [device] + ([torch.device("cpu")] if cpu and
                           device.type != "cpu" else []):
        t0 = time.perf_counter()
        sol = pt.solve_scan_turnover(
            problems.qp, n_assets=n, row_start=1, w_init=w_init, params=prm,
            universes=problems.universes, device=dev)
        dw = np.abs(sol.x[:, :n].cpu().numpy() - g_x).max(axis=1)
        same = sol.iters.cpu().numpy() == g_it
        out[dev.type] = dict(
            max_dw=float(dw.max()), at=int(dw.argmax()),
            dw=dw.tolist(), iters_equal=int(same.sum()),
            solved=int((sol.status.cpu().numpy() == 1).sum()),
            ms=(time.perf_counter() - t0) * 1e3)
        print(f"usa_turnover on {dev.type}: max|dw| to the golden "
              f"{dw.max():.3e} at date {int(dw.argmax())}, first 8 "
              f"{[float(f'{v:.3e}') for v in dw[:8]]}; solved "
              f"{out[dev.type]['solved']}/{len(dw)}; iterations equal to "
              f"the golden's on {int(same.sum())}/{len(dw)} dates; "
              f"{out[dev.type]['ms']:.0f} ms", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--cpu", action="store_true",
                    help="also run the f32 plain path on the CPU")
    ap.add_argument("--out", default=None)
    ap.add_argument("--usa", action="store_true",
                    help="also run configuration 2's turnover chain")
    ap.add_argument("--size", type=int, nargs=3, default=None,
                    metavar=("DATES", "WINDOW", "ASSETS"),
                    help="a smaller problem than the golden's (no golden "
                         "comparison)")
    a = ap.parse_args()
    device = torch.device(a.device)
    pt.qp.canonical.HP.apply()
    golden = np.load(GOLDEN)
    meta = json.loads(str(golden["meta"]))
    at_golden = a.size is None
    if not at_golden:
        meta.update(zip(("n_dates", "window", "n_assets"), a.size))
    report = {"device": (torch.cuda.get_device_name(0)
                         if device.type == "cuda" else "cpu"),
              "seeds": {}}
    for seed in a.seeds:
        f32 = problems(seed, meta, device, np.float32)
        f64 = problems(seed, meta, device, np.float64)
        cpu32 = problems(seed, meta, torch.device("cpu"), np.float32) \
            if a.cpu and device.type != "cpu" else None
        out = report["seeds"][seed] = {}
        for i, kind in enumerate(("scan_l1", "scan_l1_grid")):
            base = pt.SolverParams(**json.loads(str(golden[f"{kind}/params"])))
            twin = dataclasses.replace(base, backend="xla", linsolve=(
                "trinv" if kind == "scan_l1_grid" else base.linsolve))
            x64 = chain(kind, f64[i], meta, twin, device)
            paths = {
                "kernel": chain(kind, f32[i], meta, dataclasses.replace(
                    base, backend="pallas"), device),
                "kernel_again": chain(kind, f32[i], meta, dataclasses.replace(
                    base, backend="pallas"), device),
                "plain_" + device.type: chain(kind, f32[i], meta,
                                              dataclasses.replace(
                                                  base, backend="xla"),
                                              device)}
            if cpu32 is not None:
                paths["plain_cpu"] = chain(kind, cpu32[i], meta,
                                           dataclasses.replace(
                                               base, backend="xla"),
                                           torch.device("cpu"))
            lanes = paths["kernel"]["x"].shape[0]
            if at_golden and seed == meta["seed"]:
                paths["golden"] = dict(x=golden[f"{kind}/x"].astype(
                    np.float64).reshape(lanes, meta["n_dates"], -1),
                    status=golden[f"{kind}/status"], iters=golden[
                        f"{kind}/iters"], ms=None)
            rec = out[kind] = {"f64_ms": x64["ms"], "paths": {}}
            if at_golden and seed == meta["seed"]:
                g64 = golden[f"{kind}/x_f64"].astype(np.float64).reshape(
                    lanes, meta["n_dates"], -1)
                rec["f64_vs_golden_f64"] = float(np.abs(x64["x"] - g64).max())
            for name, p in paths.items():
                rec["paths"][name] = dict(
                    distance(p["x"], x64["x"]), ms=p["ms"],
                    solved=int((p["status"] == 1).sum()),
                    iters_equal_f64=int((np.reshape(p["iters"], (lanes, -1))
                                         == x64["iters"].reshape(lanes, -1))
                                        .sum()))
            rec["kernel_repeats_bitwise"] = bool(np.array_equal(
                paths["kernel"]["x"], paths["kernel_again"]["x"]))
            others = [np.array(rec["paths"][k]["max"]) for k in rec["paths"]
                      if not k.startswith("kernel")]
            rec["kernel_ratio_per_lane"] = (np.array(
                rec["paths"]["kernel"]["max"]) / np.maximum.reduce(others)
                ).tolist()
            print(f"seed {seed} {kind}: f64 chain {x64['ms']:.0f} ms"
                  + (f", {rec['f64_vs_golden_f64']:.3e} from the golden's"
                     if "f64_vs_golden_f64" in rec else ""), flush=True)
            for name, r in rec["paths"].items():
                print(f"  {name:>13}: max over dates per lane "
                      f"{[f'{v:.3e}' for v in r['max']]} at "
                      f"{r['at']}, first past 1e-4 {r['first_past_1e4']}; "
                      f"solved {r['solved']}, iterations equal to the f64 "
                      f"chain on {r['iters_equal_f64']}", flush=True)
            print(f"  kernel repeats bit for bit: "
                  f"{rec['kernel_repeats_bitwise']}; kernel / largest "
                  f"other f32 path per lane "
                  f"{[round(v, 3) for v in rec['kernel_ratio_per_lane']]}",
                  flush=True)
    if a.usa:
        report["usa_turnover"] = usa_turnover(golden, device, a.cpu)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
