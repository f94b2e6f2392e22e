#!/usr/bin/env python3
"""How far each CUDA segment kernel sits from the twin rule, per case.

    PYTHONPATH=. python3 scripts/torch_twin_margins.py [--all-outputs]

Runs, on the card, the kernels at the shapes of the ``gpu`` tests in
``tests/test_torch_cuda.py`` (the cluster form where the router picks
it, the streaming form everywhere) and prints, per output, the
kernel's distance to the twin run in float64 (``e_k``), the f32 twin's
own distance on the card (``e_p``) and on the CPU (``e_cpu``, the same
function summed in another order), and the rule's bound ``4 e_p + 2
n_iters ulps x scale``. ``margin`` is ``e_k / bound``: above 1 the
rule fails. ``noise`` is the same with ``e_p`` replaced by the larger
of ``e_p`` and ``e_cpu``, the rule of the dense-form tests. The line of a case shows its worst output;
``--all-outputs`` prints every output. ``e_cpu / e_p`` shows how much
of the bound is a draw of f32 rounding noise rather than a property of
the function.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Import the test module by path: an installed distribution may ship a
# regular ``tests`` package that shadows this repo's namespace one.
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_cuda as tc  # noqa: E402
from porqua_tpu_torch.ops import admm_kernel as tk  # noqa: E402

NAMES = ("x", "z", "w", "y", "mu", "dx", "dy", "dmu")
NAMED = {tk.admm_segment: tk._admm_segment_form,
         tk.admm_segment_factored: tk._admm_segment_factored_form}


def cases():
    """(label, kernel_inputs kwargs, n_iters override) for the shapes
    of the gpu tests."""
    for form in sorted(tc.FORMS):
        yield f"{form} n=10", dict(form=form), None
    for n in (5, 13, 37):
        for m in (1, 3):
            for refine in (0, 1, 2):
                yield (f"factored n={n} m={m} refine={refine}",
                       dict(form="factored_refine0", n=n, m=m,
                            refine=refine), None)
    for n, k in ((2048, 256), (512, 1024)):
        for refine in (0, 1):
            yield (f"factored n={n} k={k} refine={refine}",
                   dict(form="factored_refine0", n=n, window=k, batch=2,
                        refine=refine), None)
    yield "factored n=37 refine=1", dict(form="factored_refine1", n=37), None
    for tri in (True, False):
        for n in (5, 13, 37, 500, 1024):
            for m in ((1, 3) if n < 1024 else (1,)):
                for it in ((1, 25) if n < 1024 else (25,)):
                    yield (f"{tc.DENSE[tri]} n={n} m={m} iters={it}",
                           dict(form=tc.DENSE[tri], n=n, m=m), it)


def distances(out, exact):
    return [float((a.double().cpu() - e.cpu()).abs().max())
            for a, e in zip(out, exact)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all-outputs", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_twin_margins: no CUDA device", file=sys.stderr)
        return 1
    worst = 0.0
    for label, inputs, n_iters in cases():
        fn, args, kw = tc.kernel_inputs(dtype=np.float32, **inputs)
        if n_iters is not None:
            kw = dict(kw, n_iters=n_iters)
        twin = tc.TWIN[fn]
        exact = twin(*(a.double() for a in args), **kw)
        e_cpu = distances(twin(*args, **kw), exact)
        args = tuple(a.cuda() for a in args)
        e_p = distances(twin(*args, **kw), exact)
        floor = tc.f32_floor(kw)
        n, m = args[-1].shape[-1], args[-2].shape[-1]
        if fn is tk.admm_segment:
            chosen = tk.dense_form(n, m, kw["triangular"])
        else:
            chosen = tk.factored_form(n, m, args[0].shape[-2],
                                      kw["refine_steps"],
                                      batch=args[-1].shape[0])
        # The streaming form fits every shape here; the cluster form
        # runs where the router picks it.
        for form in sorted({chosen, "stream"}):
            out = NAMED[fn](form, *args, **kw)
            torch.cuda.synchronize()
            e_k = distances(out, exact)
            rows = []
            for i, name in enumerate(NAMES):
                scale = float(exact[tc.SCALE_OF[i]].abs().max())
                bound = 4.0 * e_p[i] + floor * scale
                wide = 4.0 * max(e_p[i], e_cpu[i]) + floor * scale
                rows.append((e_k[i] / bound if bound > 0 else 0.0,
                             e_k[i] / wide if wide > 0 else 0.0, name,
                             e_k[i], e_p[i], e_cpu[i], bound))
            shown = rows if opts.all_outputs else [max(rows)]
            for margin, noise, name, ek, ep, ec, bound in shown:
                print(f"{label:34s} {form:7s} {name:3s} margin {margin:6.3f}"
                      f" noise {noise:6.3f} e_k {ek:.3e} e_p {ep:.3e} "
                      f"e_cpu {ec:.3e} bound {bound:.3e}"
                      f"{'  FAIL' if margin > 1 else ''}", flush=True)
            worst = max(worst, max(rows)[0])
    print(f"worst margin {worst:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
