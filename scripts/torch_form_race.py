#!/usr/bin/env python3
"""Time the fused segment kernel forms against each other on the card.

    python3 scripts/torch_form_race.py [--root DIR] [--label NAME]
                                       [--match TEXT]

At each shape of CASES, every form the wrapper of ``DIR``'s
``porqua_tpu_torch`` offers (``_DENSE_LAUNCHER``/``_FACTORED_LAUNCHER``)
and whose shared memory fits the card is launched by name on the same
inputs (the kernel call of a small tracking batch's second segment,
``chip_smoke.small_kernel_call``, built for one problem and repeated
over the batch) and timed in turns: the forms in order, then in reverse,
each turn the median of 10 launches after 2 of warm-up (CUDA events).
The factored grid form runs at each of its group counts G that the
race compares: the router's (the fewest whose slices fit and whose B G
clusters the card holds at once) and as many as the card holds for
the batch, up to 16, each a form of its own ("grid G=4").
Prints one JSON line per case: the router's pick (and, for a dense
case, the rank count, the resident clusters and the tail's resident
rows the library takes; for a factored one the grid's G candidates
with their shared memory per block and the card's occupancy answer),
each form's median of both turns, each form's largest distance to the
first form's outputs, the bound of ``chip_smoke.py``'s kernel rows and
the plain twin's time. ``--root`` takes the package from another
checkout (the parent commit unpacked beside this one), so that two
versions of a kernel can be timed in one call: parent, change, change,
parent. ``--match`` keeps the cases whose label (as printed, e.g.
``factored_refine0 5000x1 k=504 r0 B=1``) contains the text.
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
# 16-block clusters the card holds at once. Then the factored shapes no
# cluster form fits, at one problem: the 5,000-asset north star's
# woodbury arms (k = 504 dense, 256 sketch-fed) and the gap rungs
# (2,048 x 8 at refine 0 and 1, 1,024 x 128), where the grid form
# races the device-memory one.
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
    for batch in (7, 8)] + [
    ("factored_refine0", n, m, k, refine, 1)
    for n, m, k, refine in [(5000, 1, 504, 0), (5000, 1, 256, 0),
                            (2048, 8, 252, 0), (2048, 8, 252, 1),
                            (1024, 128, 252, 0)]]


def label_of(family, n, m, k, refine, batch):
    return (f"{family} {n}x{m} k={k}"
            f"{'' if refine is None else f' r{refine}'} B={batch}")


def grid_candidates(lib, shape, batch, limit):
    """The grid's G candidates at this shape: {G: (shared bytes per
    block, clusters the card holds at once)} for the router's G and
    the most groups (up to 16) whose slices fit and whose batch G
    clusters the card holds at once."""
    held = {}
    for g in range(1, 17):
        need = lib.porqua_admm_cluster_grid_smem_bytes(*shape, g)
        if need <= limit:
            active = lib.porqua_admm_cluster_grid_max_active(*shape, g)
            if batch * g <= active:
                held[g] = (need, active)
    if not held:
        return {}
    routed = lib.porqua_admm_cluster_grid_groups(*shape, batch)
    return {g: held[g] for g in sorted({routed, max(held)}) if g in held}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose porqua_tpu_torch is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--match", default="")
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
        if args.match not in label_of(family, n, m, k, refine, batch):
            continue
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
            lib = tk._library(tk._CLUSTER_LIB)
            if "grid" in forms:
                chosen = tk.factored_form(n, m, k, refine, batch=batch)
                grid = grid_candidates(lib, (n, m, k, refine), batch, limit)
            else:
                chosen = tk.factored_form(n, m, k, refine)
                grid = {}
            sizes = {"stream": tk._library(tk._LIB)
                     .porqua_admm_segment_smem_bytes(1, n, m, k),
                     "cluster": lib.porqua_admm_cluster_smem_bytes(
                         n, m, k, refine)}
            if hasattr(lib, "porqua_admm_cluster_global_smem_bytes"):
                sizes["global"] = lib.porqua_admm_cluster_global_smem_bytes(
                    n, m, k, refine)
        launch = {f: (lambda f=f: named(f, *call, **kw)) for f in forms
                  if f != "grid" and sizes[f] <= limit}
        if fn is not tk.admm_segment:
            layout = {"grid": {g: {"smem": need, "active": active}
                               for g, (need, active) in grid.items()}}
            for g in grid:
                launch[f"grid G={g}"] = (
                    lambda g=g: named("grid", *call, groups=g, **kw))
        forms = list(launch)
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
            "label": args.label, "card": card,
            "case": label_of(family, n, m, k, refine, batch),
            "family": family, "n": n,
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
