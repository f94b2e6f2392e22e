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
* The load drivers: :mod:`~porqua_tpu_torch.cli.chaos_suite` (the
  degradation matrix: the fault scenarios with a real breaker pair, the
  route flap, and the cells of the other two),
  :mod:`~porqua_tpu_torch.cli.tenant_smoke` (the tenant isolation
  cells) and :mod:`~porqua_tpu_torch.cli.calibration_smoke` (the
  calibration loop's promote, poison and rollback drills); each cell
  returns the JAX script's verdict dict, and a :class:`Tally` records
  what it served where. :mod:`~porqua_tpu_torch.cli.fleet_loadgen`
  spawns N worker processes, each a service on one shard of a seeded
  arrival stream, and federates their telemetry into one reconciled
  fleet report (worker liveness, the seeded worker-crash cell).
* The analysis plane: :mod:`~porqua_tpu_torch.cli.run_checks` (the AST
  rules, the op-trace contracts and the op-trace lint) and
  :mod:`~porqua_tpu_torch.cli.hlolint_report` (the op-trace lint joined
  to the fingerprints of ``testdata/op_baseline.json``).

The tools that run anything on a device take ``--device`` (last among
their options): the card by default, which raises without one;
``--device cpu`` runs on the host. The readers only read files.
"""

import contextlib


class Tally:
    """What a caller reads beside the load drivers' verdicts
    (:mod:`~porqua_tpu_torch.cli.chaos_suite`,
    :mod:`~porqua_tpu_torch.cli.tenant_smoke`,
    :mod:`~porqua_tpu_torch.cli.calibration_smoke`), one record per cell
    in ``cells``: per phase of the cell, the device label of each answer
    by round in submission order (``rounds``) and, with ``counter`` (a
    callable that returns a launch count), the launches between the
    start and the end of the phase's rounds; and how many times each
    ticket's future ran its done callbacks (``resolutions``). The
    phases: ``warm`` (the clean round before a fault window), ``window``
    (inside it), ``recovery`` (the clean rounds after it), and the
    calibration drills' ``routed`` and ``restored`` rounds."""

    def __init__(self, counter=None):
        self.counter = counter
        self.cells = []

    def open(self, cell, mode):
        self.cells.append({"cell": cell, "mode": mode, "phases": {},
                           "resolutions": []})

    def _phase(self, phase):
        return self.cells[-1]["phases"].setdefault(
            phase, {"rounds": [], "launches": 0})

    def _count(self):
        return 0 if self.counter is None else int(self.counter())

    @contextlib.contextmanager
    def round(self, phase):
        """One round of ``phase``: its answers go to a new round list."""
        record = self._phase(phase)
        record["rounds"].append([])
        before = self._count()
        try:
            yield
        finally:
            record["launches"] += self._count() - before

    def ticket(self, ticket):
        """Count ``ticket``'s resolutions; returns it."""
        calls = self.cells[-1]["resolutions"]
        i = len(calls)
        calls.append(0)
        ticket.future.add_done_callback(
            lambda _f: calls.__setitem__(i, calls[i] + 1))
        return ticket

    def answer(self, phase, result):
        """Record one answer of the current round of ``phase``."""
        self._phase(phase)["rounds"][-1].append(result.device)
