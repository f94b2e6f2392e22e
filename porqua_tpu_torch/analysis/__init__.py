"""Runtime sanitizers (the port of ``porqua_tpu/analysis``, in part):
the compile bookkeeping of :mod:`~porqua_tpu_torch.analysis.sanitize`
and the lock-order sanitizer :mod:`~porqua_tpu_torch.analysis.tsan`,
both host code. The static lint rules and the jaxpr/HLO contracts are
not ported (ROADMAP queue A, item 23)."""
