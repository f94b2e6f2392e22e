"""Cross-solver comparison on the MSCI index-tracking problem.

The port's twin of the JAX package's ``examples/compare_solver.py`` (the
reference's ``example/compare_solver.ipynb``): build one LeastSquares
tracking problem (budget, long-only box with a 0.1 cap), run it through
every available solver backend, and print the
accuracy/reliability/runtime table (notebook cells 6-9). The backends
are the device ADMM solver at f32 and f64, the native C++ ADMM core,
scipy SLSQP and the f64 interior-point oracle, plus any installed
qpsolvers backends.

    python -m porqua_tpu_torch.examples.compare_solver [--device cpu]
"""

import pandas as pd
import torch

from porqua_tpu_torch.examples._common import (load_msci_or_synthetic,
                                               parse_device)


def main(device=None):
    from porqua_tpu_torch import (Constraints, LeastSquares, OptimizationData,
                                  compare_solvers)
    from porqua_tpu_torch.qp.solve import resolve_device

    dev = resolve_device(device)
    data = load_msci_or_synthetic()
    X = data["return_series"].tail(1260)
    y = data["bm_series"].reindex(X.index).iloc[:, 0]
    universe = list(X.columns)

    constraints = Constraints(selection=universe)
    constraints.add_budget()
    constraints.add_box("LongOnly", upper=0.1)

    opt = LeastSquares(dtype=torch.float64)
    opt.constraints = constraints
    opt.set_objective(OptimizationData(align=False, return_series=X,
                                       bm_series=y))
    qp = opt.model_canonical(device=dev)
    print(f"problem: n={qp.n} assets, m={qp.m} constraint rows, "
          f"T={len(X)} observations")

    df = compare_solvers(qp, device=dev)
    with pd.option_context("display.width", 160,
                           "display.float_format", lambda v: f"{v:.3e}"):
        print(df)

    objs = df.loc[df["solution_found"].astype(bool), "objective_value"]
    spread = float(objs.max() - objs.min())
    print(f"\nobjective spread across backends: {spread:.2e}")
    return {"table": df, "spread": spread, "n": qp.n, "m": qp.m}


if __name__ == "__main__":
    main(parse_device(__doc__.splitlines()[0]))
