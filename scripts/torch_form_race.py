#!/usr/bin/env python3
"""Time the fused segment kernel forms against each other on the card.

    python3 scripts/torch_form_race.py [--root DIR] [--label NAME]

At each shape of CASES, every form the wrapper of ``DIR``'s
``porqua_tpu_torch`` offers (``_DENSE_LAUNCHER``/``_FACTORED_LAUNCHER``)
and whose shared memory fits the card is launched by name on the same
inputs (the kernel call of a small tracking batch's second segment,
``chip_smoke.small_kernel_call``, built for one problem and repeated
over the batch) and timed in turns: the forms in order, then in reverse,
each turn the median of 10 launches after 2 of warm-up (CUDA events).
Prints one JSON line per case: the router's pick (and, for a dense
case, the rank count, the resident clusters and the tail's resident
rows the library takes), each form's median of both turns, each
form's largest distance to the first form's outputs, the bound of
``chip_smoke.py``'s kernel rows and the plain twin's time. ``--root``
takes the package from another checkout (the parent commit unpacked
beside this one), so that two versions of a kernel can be timed in one
call: parent, change, change, parent.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (family, n, m, window k, refine, batch): the dense forms at the
# tracking shape (n = 500) and at 1,024 assets (the 16-rank cluster for
# L^-1, the streamed tail for K^-1, against the one-block form); the
# factored streaming and device-memory forms at the shapes where both
# fit and the router takes the streaming one (a four-year window over
# 512 assets, 2,048 assets at the sketch's 256 rows) and at the
# tracking shape; each at one problem and at 64. Then the service's
# wide dense rungs (1,024 x 128, 512 x 512, 1,024 x 1) at B = 8, the
# batch of chip_smoke.py's phase 8e, and B = 7, one wave of the
# 16-block clusters the card holds at once.
CASES = [(family, n, m, k, refine, batch)
         for family, n, m, k, refine in [
             ("triangular", 500, 1, 24, None),
             ("inverse", 500, 1, 24, None),
             ("triangular", 1024, 8, 24, None),
             ("inverse", 1024, 8, 24, None),
             ("factored_refine0", 500, 1, 252, 0),
             ("factored_refine0", 512, 1, 1024, 0),
             ("factored_refine0", 2048, 1, 256, 0)]
         for batch in (1, 64)] + [
    (family, n, m, 24, None, batch)
    for n, m in [(1024, 128), (512, 512), (1024, 1)]
    for family in ("triangular", "inverse")
    for batch in (7, 8)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose porqua_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), HERE]

    import torch

    if not torch.cuda.is_available():
        print("torch_form_race: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke
    from porqua_tpu_torch.ops import admm_kernel as tk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package {tk.__file__}", flush=True)
    limit = tk._library(tk._LIB).porqua_max_smem_optin()
    layout = None
    for family, n, m, k, refine, batch in CASES:
        fn, call, kw = chip_smoke.small_kernel_call(
            family, np.float32, n=n, m=m, window=k, batch=1, refine=refine)
        call = tuple(a.cuda().expand(batch, *a.shape[1:]).contiguous()
                     for a in call)
        if fn is tk.admm_segment:
            named, forms = tk._admm_segment_form, list(tk._DENSE_LAUNCHER)
            chosen = tk.dense_form(n, m, kw["triangular"])
            lib, tri = tk._library(tk._DENSE_LIB), int(kw["triangular"])
            sizes = {"stream": tk._library(tk._LIB)
                     .porqua_admm_segment_smem_bytes(0, n, m, 0),
                     "cluster": lib.porqua_admm_dense_cluster_smem_bytes(
                         n, m, tri)}
            if hasattr(lib, "porqua_admm_dense_tail_smem_bytes"):
                sizes["tail"] = lib.porqua_admm_dense_tail_smem_bytes(
                    n, m, tri)
                layout = {
                    "ranks": lib.porqua_admm_dense_cluster_ranks(n, m, tri),
                    "active": lib.porqua_admm_dense_cluster_max_active(
                        n, m, tri),
                    "tail_rows": lib.porqua_admm_dense_tail_rows(n, m, tri),
                    "tail_active": lib.porqua_admm_dense_tail_max_active(
                        n, m, tri)}
        else:
            named, forms = (tk._admm_segment_factored_form,
                            list(tk._FACTORED_LAUNCHER))
            chosen = tk.factored_form(n, m, k, refine)
            lib = tk._library(tk._CLUSTER_LIB)
            sizes = {"stream": tk._library(tk._LIB)
                     .porqua_admm_segment_smem_bytes(1, n, m, k),
                     "cluster": lib.porqua_admm_cluster_smem_bytes(
                         n, m, k, refine)}
            if hasattr(lib, "porqua_admm_cluster_global_smem_bytes"):
                sizes["global"] = lib.porqua_admm_cluster_global_smem_bytes(
                    n, m, k, refine)
        forms = [f for f in forms if sizes[f] <= limit]
        if fn is not tk.admm_segment:
            layout = None
        launch = {f: (lambda f=f: named(f, *call, **kw)) for f in forms}
        first = launch[forms[0]]()
        dist = {}
        for f in forms:
            out = launch[f]()
            torch.cuda.synchronize()
            dist[f] = max(float((a - b).abs().max())
                          for a, b in zip(out, first))
        samples = {f: [] for f in forms}
        for f in forms + forms[::-1]:
            samples[f] += chip_smoke.cuda_times(launch[f], 2, 10)
        # The bound (as chip_smoke.py's kernel rows take it) and the
        # plain twin's time on the same call.
        flops, nbytes = tk.launch_cost(fn.__name__, call, kw)
        bound_ms = max(flops / chip_smoke.PEAK_F32_FLOPS,
                       nbytes / chip_smoke.PEAK_BYTES_S) * 1e3
        plain = (tk.admm_segment_ref if fn is tk.admm_segment
                 else tk.admm_segment_factored_ref)
        plain_ms = chip_smoke.cuda_ms(lambda: plain(*call, **kw), 1, 3)
        print(json.dumps({
            "label": args.label, "card": card, "family": family, "n": n,
            "m": m, "k": k if fn is not tk.admm_segment else None,
            "refine": refine, "batch": batch, "n_iters": kw["n_iters"],
            "router": chosen, "layout": layout, "bound_ms": bound_ms,
            "plain_ms": plain_ms,
            "ms": {f: statistics.median(samples[f]) for f in forms},
            "turn_ms": {f: [statistics.median(samples[f][:10]),
                            statistics.median(samples[f][10:])]
                        for f in forms},
            "max_abs_diff_to_first": dist}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
