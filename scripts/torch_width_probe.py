#!/usr/bin/env python3
"""Does a lane's segment arithmetic depend on the batch width?

    PYTHONPATH=. python3 scripts/torch_width_probe.py [--device cuda]

On the headline batch of ``chip_smoke.py``'s phase 8 (the configs of
``porqua_tpu_torch/testdata/secondary_golden.npz``), prepares all 252
dates at once and the first ``w`` dates alone, steps both three
segments with ``qp/solve.py::segment_step_batch``, and prints per
segment how many of the ``w`` lanes are bit-identical in x and the
largest difference. The compacting driver keeps a date's bits only
where its arithmetic does not depend on the width it is stepped at.
The K1/K2 configs run with ``backend="pallas"`` (the kernels) and
``"xla"`` (the plain segment); NAPG has no kernel. Needs the card
unless ``--device cpu``.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import porqua_tpu_torch as pt  # noqa: E402
from porqua_tpu_torch.qp.solve import (prepare_batch,  # noqa: E402
                                       resolve_device, segment_step_batch)

GOLDEN = os.path.join(ROOT, "porqua_tpu_torch", "testdata",
                      "secondary_golden.npz")
CONFIGS = (("compact_woodbury", ("pallas", "xla")),
           ("compact_trinv", ("pallas", "xla")),
           ("compact_napg", ("xla",)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--widths", type=int, nargs="+", default=[128, 64, 2])
    ap.add_argument("--segments", type=int, default=3)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    golden = np.load(GOLDEN)
    meta = json.loads(str(golden["meta"]))
    Xs, ys = pt.synthetic_universe_np(meta["seed"], meta["n_dates"],
                                      meta["window"], meta["n_assets"])
    pt.qp.canonical.HP.apply()
    qps = pt.build_tracking_qp(torch.as_tensor(Xs, device=dev),
                               torch.as_tensor(ys, device=dev))
    B = qps.q.shape[0]
    print(f"device {dev}; batch {B}", flush=True)
    for name, backends in CONFIGS:
        for backend in backends:
            p = json.loads(str(golden[f"{name}/params"]))
            p["backend"] = backend
            prm = pt.SolverParams(**p)
            full = prepare_batch(qps, prm)
            for w in args.widths:
                sub = type(qps)(*(None if f is None else f[:w] for f in qps))
                part = prepare_batch(sub, prm)
                same_prep = all(torch.equal(a[:w], b) for a, b in
                                zip(full[2].state, part[2].state)
                                if a is not None)
                c_full, c_part, per_segment = full[2], part[2], []
                for _ in range(args.segments):
                    c_full = segment_step_batch(full[0], full[1], c_full, prm)
                    c_part = segment_step_batch(part[0], part[1], c_part, prm)
                    a, b = c_full.state.x[:w], c_part.state.x
                    per_segment.append(
                        (int((a == b).all(dim=1).sum()),
                         float((a - b).abs().max())))
                print(f"{name} [{backend}] width {w} of {B}: prepared carry "
                      f"bit-equal {same_prep}; per segment (lanes bit-equal "
                      f"of {w}, max|dx|) {per_segment}", flush=True)


if __name__ == "__main__":
    main()
