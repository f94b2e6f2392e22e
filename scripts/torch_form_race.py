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
Prints one JSON line per case: the router's pick, each form's median of
both turns, and each form's largest distance to the first form's
outputs. ``--root`` takes the package from another checkout (the
parent commit unpacked beside this one), so that two versions of a
kernel can be timed in one call: parent, change, change, parent.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (family, n, m, window k, refine, batch): the dense streaming form at
# the tracking shape (n = 500) and at 1,024 assets, where it is the
# route; the factored streaming and device-memory forms at the shapes
# where both fit and the router takes the streaming one (a four-year
# window over 512 assets, 2,048 assets at the sketch's 256 rows) and
# at the tracking shape; each at one problem and at 64.
CASES = [(family, n, m, k, refine, batch)
         for family, n, m, k, refine in [
             ("triangular", 500, 1, 24, None),
             ("inverse", 500, 1, 24, None),
             ("triangular", 1024, 8, 24, None),
             ("inverse", 1024, 8, 24, None),
             ("factored_refine0", 500, 1, 252, 0),
             ("factored_refine0", 512, 1, 1024, 0),
             ("factored_refine0", 2048, 1, 256, 0)]
         for batch in (1, 64)]


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
    for family, n, m, k, refine, batch in CASES:
        fn, call, kw = chip_smoke.small_kernel_call(
            family, np.float32, n=n, m=m, window=k, batch=1, refine=refine)
        call = tuple(a.cuda().expand(batch, *a.shape[1:]).contiguous()
                     for a in call)
        if fn is tk.admm_segment:
            named, forms = tk._admm_segment_form, list(tk._DENSE_LAUNCHER)
            chosen = tk.dense_form(n, m, kw["triangular"])
            sizes = {"stream": tk._library(tk._LIB)
                     .porqua_admm_segment_smem_bytes(0, n, m, 0),
                     "cluster": tk._library(tk._DENSE_LIB)
                     .porqua_admm_dense_cluster_smem_bytes(
                         n, m, int(kw["triangular"]))}
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
        print(json.dumps({
            "label": args.label, "card": card, "family": family, "n": n,
            "m": m, "k": k if fn is not tk.admm_segment else None,
            "refine": refine, "batch": batch, "n_iters": kw["n_iters"],
            "router": chosen,
            "ms": {f: statistics.median(samples[f]) for f in forms},
            "turn_ms": {f: [statistics.median(samples[f][:10]),
                            statistics.median(samples[f][10:])]
                        for f in forms},
            "max_abs_diff_to_first": dist}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
