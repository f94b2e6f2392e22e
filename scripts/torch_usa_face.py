#!/usr/bin/env python3
"""Why the USA example's backtest weights are fixed only up to f32
rounding: the numbers behind PERF.md section 6 and ROADMAP
section C.

    PYTHONPATH=. python scripts/torch_usa_face.py [--device cuda] [--dates N]

For ``examples/backtest_usa.py`` configuration 1 (the first N of its 55
dates) and both solver configs of the committed golden
(``porqua_tpu_torch/testdata/backtest_usa_golden.npz``, the JAX
package's run_batch on XLA-CPU in f32 and its f64 twin), it prints:

- the golden's f32 ADMM iterate against its f64 iterate, and the port's
  f32 iterate (this device) against both;
- each polish pass of the port in f32 and in f64: on how many dates the
  candidate beats the ADMM iterate, and the smallest ratio of the
  candidate's max residual to the iterate's (the polish accepts below 1);
- the in-sample tracking error (RMSE of X w - y over the window) of the
  golden's f32 weights and of the f64 polished weights: the benchmark
  is a portfolio of the universe and the window is shorter than the
  universe, so every date's optimum replicates it exactly and is a face,
  not a point.

Imports no JAX; runs on the CPU unless ``--device`` names the card.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import porqua_tpu_torch as pt  # noqa: E402
from porqua_tpu_torch import builders as tb  # noqa: E402
from porqua_tpu_torch.batch import build_problems  # noqa: E402
from porqua_tpu_torch.qp import polish  # noqa: E402
from porqua_tpu_torch.qp.admm import _residuals  # noqa: E402
from porqua_tpu_torch.qp.solve import _backend, _prepare_impl  # noqa: E402
from porqua_tpu_torch.synthetic import (  # noqa: E402
    synthetic_usa_np, usa_benchmark_np, usa_rebdates)

GOLDEN = os.path.join(os.path.dirname(pt.__file__), "testdata",
                      "backtest_usa_golden.npz")


def service(X, bm, rebdates, meta):
    O = pt.OptimizationItemBuilder
    return pt.BacktestService(
        data={"return_series": X, "bm_series": bm},
        selection_item_builders={
            "data": pt.SelectionItemBuilder(bibfn=tb.bibfn_selection_data)},
        optimization_item_builders={
            "returns": O(bibfn=tb.bibfn_return_series, width=meta["width"]),
            "bm": O(bibfn=tb.bibfn_bm_series, width=meta["width"], align=True),
            "budget": O(bibfn=tb.bibfn_budget_constraint),
            "box": O(bibfn=tb.bibfn_box_constraints, upper=meta["upper"])},
        optimization=pt.LeastSquares(),
        settings={"rebdates": rebdates, "quiet": True})


def polish_passes(qp, prm):
    """Per pass: dates whose candidate beats the iterate, and the
    smallest candidate/iterate ratio of the max residual."""
    scaled, scaling = _prepare_impl(qp, prm)[:2]
    st = _backend(prm)[2](scaled, scaling, prm)
    point = (st.x, st.z, st.w, st.y, st.mu)
    rp0, rd0 = _residuals(scaled, scaling, *point, prm)[:2]
    best = torch.maximum(rp0, rd0)
    out, guess = [], point
    for _ in range(prm.polish_passes):
        cand, err, finite, ok = polish._polish_pass(scaled, scaling, prm,
                                                    *guess)
        better = (err < best) & finite & ok
        out.append((int(better.sum()), float((err / best).min())))
        keep = polish._lane(finite & ok, cand[0])
        guess = tuple(torch.where(keep, c, g) for c, g in zip(cand, guess))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dates", type=int, default=55)
    args = ap.parse_args()
    pt.qp.canonical.HP.apply()
    golden = np.load(GOLDEN)
    meta = json.loads(str(golden["meta"]))
    X, _ = synthetic_usa_np(n_days=meta["n_days"], n_assets=meta["n_assets"])
    bm = usa_benchmark_np(X)
    rebdates = usa_rebdates(X.index)[:args.dates]
    D = len(rebdates)
    problems = {dt: build_problems(service(X, bm, rebdates, meta), dtype=dt)
                for dt in (torch.float32, torch.float64)}
    qp64 = problems[torch.float64].qp

    def rmse(w):
        val = qp64.objective_value(torch.tensor(w)).numpy()
        return np.sqrt(np.maximum(val, 0.0) / meta["width"])

    print(f"{D} dates x {meta['n_assets']} assets, window {meta['width']}, "
          f"device {args.device}")
    for name in ("usa_trinv", "usa_woodbury"):
        g = {k: golden[f"{name}/{k}"][:D] for k in (
            "weights", "weights_nopolish", "weights_f64",
            "weights_nopolish_f64", "polish_accepted",
            "polish_accepted_f64")}
        base = pt.SolverParams(**json.loads(str(golden[f"{name}/params"])))
        print(f"[{name}] golden: f32 iterate to f64 iterate max "
              f"{np.abs(g['weights_nopolish'] - g['weights_nopolish_f64']).max():.3e}; "
              f"polish accepted f32 {int(g['polish_accepted'].sum())}/{D}, "
              f"f64 {int(g['polish_accepted_f64'].sum())}/{D}")
        for dt in (torch.float32, torch.float64):
            qp = pt.CanonicalQP(*(None if f is None else f.to(args.device)
                                  for f in problems[dt].qp))
            if dt == torch.float32:
                sol = pt.solve_qp_batch(
                    qp, dataclasses.replace(base, polish=False),
                    device=args.device)
                x = sol.x.double().cpu().numpy()
                print(f"[{name}] port f32 iterate: to the golden's max "
                      f"{np.abs(x - g['weights_nopolish']).max():.3e}, to "
                      f"the f64 iterate max "
                      f"{np.abs(x - g['weights_nopolish_f64']).max():.3e}")
            for k, (n_better, ratio) in enumerate(polish_passes(qp, base)):
                print(f"[{name}] port {str(dt)[6:]} polish pass {k}: "
                      f"candidate beats the iterate on {n_better}/{D} "
                      f"dates; smallest residual ratio {ratio:.3e}")
        print(f"[{name}] in-sample TE: golden f32 median "
              f"{np.median(rmse(g['weights'])):.3e} max "
              f"{rmse(g['weights']).max():.3e}; f64 polished max "
              f"{rmse(g['weights_f64']).max():.3e}; f32 vs f64 polished "
              f"weights max {np.abs(g['weights'] - g['weights_f64']).max():.3e}")
    print(f"benchmark daily std {float(bm.iloc[:, 0].std()):.4f}; simulated "
          f"TE golden {float(golden['usa_trinv/tracking_error']):.6e}, f64 "
          f"twin {float(golden['usa_trinv/tracking_error_f64']):.6e}")


if __name__ == "__main__":
    main()
