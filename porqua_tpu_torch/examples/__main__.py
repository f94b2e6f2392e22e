"""Run every example in turn, one status line each; exit 1 if any
fails (the twin of the JAX package's ``scripts/run_examples.sh``).

    python -m porqua_tpu_torch.examples [--device cpu] [name ...]

``ml_prediction``'s boosting step needs sklearn: where it is not
installed the example runs without it, and its status line says so.
"""

import argparse
import importlib
import importlib.util
import sys
import time
import traceback

from porqua_tpu_torch.examples import EXAMPLES


def run(names, device=None):
    """Run the named examples' ``main``; returns {name: error or None}."""
    failed = {}
    for name in names:
        module = importlib.import_module(f"porqua_tpu_torch.examples.{name}")
        kwargs, note = {}, ""
        if name == "ml_prediction" and importlib.util.find_spec(
                "sklearn") is None:
            kwargs["boosting"] = False
            note = " (boosting left out: sklearn is not installed)"
        print(f"=== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            module.main(device, **kwargs)
            failed[name] = None
        except Exception as exc:
            traceback.print_exc()
            failed[name] = f"{type(exc).__name__}: {exc}"
        status = "ok  " if failed[name] is None else "FAIL"
        print(f"{status} {name} {time.perf_counter() - t0:.1f} s{note}",
              flush=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    ap.add_argument("names", nargs="*", help="examples to run (default: all)")
    opts = ap.parse_args(argv)
    unknown = set(opts.names) - set(EXAMPLES)
    if unknown:
        ap.error(f"unknown examples {sorted(unknown)}; known: "
                 f"{', '.join(EXAMPLES)}")
    failed = run(opts.names or EXAMPLES, opts.device)
    bad = [n for n, err in failed.items() if err is not None]
    print(f"{len(failed) - len(bad)}/{len(failed)} examples passed"
          + (f"; failed: {', '.join(bad)}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
