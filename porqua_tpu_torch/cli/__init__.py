"""The port's command-line tools (the twins of the JAX package's
``scripts/``): each module has ``main(argv=None) -> int`` and runs as
``python -m porqua_tpu_torch.cli.<name>``, with the JAX script's flags,
defaults, output text and JSON keys.

* Producers: :mod:`~porqua_tpu_torch.cli.serve_loadgen` (the serving
  load generator and its artifact flags),
  :mod:`~porqua_tpu_torch.cli.tsan_smoke` (the load generator under the
  lock-order sanitizer) and :mod:`~porqua_tpu_torch.cli.slo_smoke` (one
  injected device loss through the SLO engine and the flight recorder).
* Readers of what they write: :mod:`~porqua_tpu_torch.cli.obs_report`
  (spans, events, metrics, harvest, CostRecords, fleet and tenant
  reports), :mod:`~porqua_tpu_torch.cli.harvest_report` (the harvest
  policy table), :mod:`~porqua_tpu_torch.cli.incident_report` (a flight
  bundle) and :mod:`~porqua_tpu_torch.cli.roofline_report` (CostRecords
  ranked against the card's ridge point).
* The analysis plane: :mod:`~porqua_tpu_torch.cli.run_checks` (the AST
  rules, the op-trace contracts and the op-trace lint) and
  :mod:`~porqua_tpu_torch.cli.hlolint_report` (the op-trace lint joined
  to the fingerprints of ``testdata/op_baseline.json``).

The tools that run anything on a device take ``--device`` (last among
their options): the card by default, which raises without one;
``--device cpu`` runs on the host. The readers only read files.
"""
