"""graftcheck for the port: static analysis and sanitizers for the
device discipline (the port of ``porqua_tpu/analysis``).

* :mod:`porqua_tpu_torch.analysis.lint`: AST rules GC001-GC005 and
  GC007, restated for torch (precision, host syncs in hot code,
  recompiles and kernel builds, debug hooks, CUDA work at import, fault
  seams). Pure stdlib.
* :mod:`porqua_tpu_torch.analysis.guards`: GC006, the
  ``# guarded-by:`` thread-safety lint.
* :mod:`porqua_tpu_torch.analysis.concurrency`: GC008-GC010, inferred
  lock discipline, static lock-order deadlock detection, blocking calls
  under a lock.
* :mod:`porqua_tpu_torch.analysis.contracts`: GC101-GC111, contracts on
  the op trace of every public entry point, run on real inputs (loaded
  lazily: it imports the solver).
* :mod:`porqua_tpu_torch.analysis.hlolint`: GC201-GC206 over the op
  trace rendered as text (fusion miss, redundant op, layout churn,
  padding waste, peak budget, dtype drift); its harvester
  :mod:`porqua_tpu_torch.analysis.hlo` records every entry point's
  trace (loaded lazily).
* :mod:`porqua_tpu_torch.analysis.sanitize`: the ``PORQUA_SANITIZE=1``
  runtime mode, the transfer guard around solver dispatches and zero
  recompiles after warmup in serving.
* :mod:`porqua_tpu_torch.analysis.tsan`: the ``PORQUA_TSAN=1``
  lock-order sanitizer.

Suppressions: ``# graftcheck: disable=GC00x`` per line,
``# graftcheck: disable-file=GC00x`` per file.
"""

from porqua_tpu_torch.analysis.lint import (  # noqa: F401
    Finding,
    RULE_DOCS,
    scan_paths,
    suppression_stats,
)
from porqua_tpu_torch.analysis.guards import check_guarded_by  # noqa: F401
from porqua_tpu_torch.analysis.concurrency import check_concurrency  # noqa: F401
from porqua_tpu_torch.analysis import sanitize  # noqa: F401
from porqua_tpu_torch.analysis import tsan  # noqa: F401

__all__ = [
    "Finding",
    "RULE_DOCS",
    "scan_paths",
    "suppression_stats",
    "check_guarded_by",
    "check_concurrency",
    "sanitize",
    "tsan",
    "contracts",
    "hlo",
    "hlolint",
]


def __getattr__(name):
    # `contracts` and `hlo` import the solver at call time; loading them
    # lazily keeps this package free of import cycles with the modules
    # that import `sanitize` from here, and skips the recorder when only
    # the AST rules are wanted. `hlolint` is stdlib-light but pulled
    # lazily for symmetry.
    if name in ("contracts", "hlo", "hlolint"):
        import importlib

        return importlib.import_module(f"porqua_tpu_torch.analysis.{name}")
    raise AttributeError(name)
