"""The port's load drivers under ``porqua_tpu_torch/cli/``
(``chaos_suite``, ``tenant_smoke``, ``calibration_smoke``) against the
JAX package's scripts.

The drivers' verdicts are dicts of invariants, each with ``ok`` and a
``detail``. A twin's verdict keeps the JAX script's keys and invariant
names, and every invariant holds in both packages on the same seed: the
JAX functions (loaded from ``scripts/``) and the twins' give verdicts
equal to ``VERDICTS`` in their keys and invariant names, all true. Tier
1 runs one cell per driver on each side (``device_lost``,
``noisy_neighbor`` and ``calibration_poison``, classic mode: the JAX
function alone, the twin inside its smoke), the tests marked ``slow``
the rest of the matrix side by side. ``VERDICTS`` was taken from the
JAX matrix on the CPU (its ``slow`` test holds it there). The twins'
``--help`` names the JAX script's options and ``--device``;
``breaker_pair`` gives the chaos cells two labels of the host on the
CPU (``cpu:1``, ``cpu``); phase 16 of ``chip_smoke.py`` is rehearsed
on the CPU with the kernel calls stubbed.
"""

import json
import re

import numpy as np
import pytest
import torch

from tests.test_torch_cli import jax_options, jax_script, twin

DRIVERS = ("calibration_smoke", "chaos_suite", "tenant_smoke")

SCENARIO_KEYS = ("counters", "event_kinds", "fault_log", "faults_injected",
                 "invariants", "mode", "ok", "scenario")
TENANT_KEYS = ("cell", "invariants", "mode", "ok",
               "recompiles_after_warmup", "tenants")
FAULT_INVARIANTS = ("zero_wrong_answers", "fault_fired", "bounded_failures",
                    "recovered", "expected_events", "incident_bundle")
TENANT_INVARIANTS = ("victim_zero_shed", "victim_no_missed_deadline",
                     "victim_slo_clean", "offender_alert_fired",
                     "incident_bundle_tenant", "tenant_reconciliation",
                     "zero_wrong_answers")

#: Per cell: the verdict's keys (as its driver returns it) and its
#: invariants, in order; every one holds.
VERDICTS = {
    **{name: (SCENARIO_KEYS, FAULT_INVARIANTS + (
        ("breaker_cycle",) if name in ("device_lost", "probe_blackhole")
        else ())) for name in ("device_lost", "probe_blackhole",
                               "nan_lanes", "compile_storm", "queue_stall",
                               "clock_skew", "feed_corrupt")},
    "noisy_neighbor": (TENANT_KEYS,
                       TENANT_INVARIANTS + ("offender_shed_at_quota",)),
    "tenant_feed_corrupt": (TENANT_KEYS,
                            TENANT_INVARIANTS + ("poisoned_all_failed",)),
    "solver_route_flap": (
        ("counters", "invariants", "mode", "ok", "router", "scenario"),
        ("zero_wrong_answers", "all_backends_served", "zero_recompiles",
         "zero_failures")),
    "calibration_promote": (
        ("cell", "counters", "invariants", "mode", "ok", "table",
         "version"),
        ("canary_then_promoted", "promoted_route_served",
         "zero_wrong_answers", "zero_failures", "zero_recompiles",
         "guard_settled", "audit_replays_to_active")),
    "calibration_poison": (
        ("cell", "counters", "invariants", "mode", "ok"),
        ("poison_rejected", "no_promotion", "zero_wrong_answers",
         "validation_gate_engaged")),
    "calibration_rollback": (
        ("cell", "counters", "invariants", "mode", "ok",
         "promoted_version", "rolled_version"),
        ("promoted_then_rolled_back", "version_bumped_never_reused",
         "one_rollback_bundle", "audit_replays_to_active",
         "cooldown_refuses_recandidate", "zero_wrong_answers",
         "zero_failures", "zero_recompiles", "promoted_route_served")),
}

#: The cell of each driver that tier 1 runs in both packages.
TIER1 = {"chaos_suite": "device_lost", "tenant_smoke": "noisy_neighbor",
         "calibration_smoke": "calibration_poison"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # The drivers' services solve 8 x 4 problems; one thread keeps the
    # workers of a parallel run off each other's cores.
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def shape(verdict):
    """A verdict's keys and its invariants' names and booleans."""
    return (tuple(sorted(verdict)),
            {k: v["ok"] for k, v in verdict["invariants"].items()})


def assert_reference(name, verdict):
    keys, invariants = VERDICTS[name]
    got_keys, got = shape(verdict)
    assert got_keys == tuple(sorted(keys)), (name, got_keys)
    assert list(got) == list(invariants), (name, list(got))
    assert all(got.values()), (name, {k: v["detail"] for k, v in
                                      verdict["invariants"].items()
                                      if not v["ok"]})
    assert verdict["ok"]


def jax_cell(name, mode):
    """One cell of the JAX matrix, by name, on the CPU."""
    chaos = jax_script("chaos_suite")
    if name in chaos.TENANT_CELLS:
        return jax_script("tenant_smoke").run_tenant_cell(name, mode=mode)
    if name.startswith("calibration"):
        return jax_script("calibration_smoke").run_calibration_cell(
            name, mode=mode)
    from porqua_tpu.qp.solve import SolverParams
    from porqua_tpu.serve.bucketing import BucketLadder, ExecutableCache

    params = SolverParams(max_iter=500, eps_abs=1e-5, eps_rel=1e-5,
                          polish=False, check_interval=25)
    qps, refs = chaos._build_requests(chaos.N_REQUESTS, params)
    ladder = BucketLadder(n_rungs=(8,), m_rungs=(4,))
    if name in chaos.ROUTE_CELLS:
        return chaos.run_route_flap_cell(mode, 0, qps, refs, params,
                                         ladder)
    return chaos.run_scenario(name, mode, 0, qps, refs, params, ladder,
                              ExecutableCache(params))


def port_cell(name, mode, tally=None):
    """The same cell through the twins, on the CPU."""
    chaos = twin("chaos_suite")
    if name == "calibration_promote":
        return twin("calibration_smoke").run_calibration_cell(
            name, mode=mode, device="cpu", tally=tally)
    params = twin("calibration_smoke").reference_params()
    from porqua_tpu_torch.serve.bucketing import BucketLadder, ExecutableCache

    qps, refs = chaos._build_requests(chaos.N_REQUESTS, params)
    verdict = chaos.run_cell(name, mode, 0, qps, refs, params,
                             BucketLadder(n_rungs=(8,), m_rungs=(4,)),
                             ExecutableCache(params), device="cpu",
                             tally=tally)
    if name in chaos.TENANT_CELLS + chaos.CALIBRATION_CELLS:
        verdict["cell"] = verdict.pop("scenario")
    return verdict


# ---------------------------------------------------------------------------
# the drivers' cells (the longest tests first: a parallel run starts them
# first)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,argv", [
    ("chaos_suite", ["--selftest"]),
    ("calibration_smoke", ["--selftest"]),
    ("tenant_smoke", [])])
def test_smoke_passes_on_the_cpu(name, argv, tmp_path, capsys):
    """Each twin's smoke (the chaos selftest's three cells, the three
    calibration drills, the noisy neighbour) under ``--device cpu``:
    exit 0, and the tier-1 cell's verdict is the JAX function's."""
    report = str(tmp_path / "report.json")
    capsys.readouterr()
    rc = twin(name).main([*argv, "--device", "cpu", "--report", report])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(report) as f:
        assert json.load(f) == line
    assert rc == 0 and line["ok"]
    cells = {c.get("scenario", c.get("cell")): c for c in line["cells"]}
    assert_reference(TIER1[name], cells[TIER1[name]])
    if name == "chaos_suite":
        assert [(c["scenario"], c["mode"]) for c in line["cells"]] == \
            [tuple(c) for c in twin(name).SELFTEST]
        assert line["backend"] == "cpu" and line["n_devices"] == 2


@pytest.mark.parametrize("name", sorted(TIER1.values()))
def test_jax_cell_gives_the_reference_verdict(name):
    """The JAX function behind each twin's tier-1 cell, on the same seed:
    the same keys and invariant names, every one true."""
    assert_reference(name, jax_cell(name, "classic"))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 16, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_rehearse_phase16_on_the_cpu(monkeypatch):
    """``chip_smoke.load_driver_phase`` on the CPU with the promote
    drill and five cells of its continuous column (the classic column
    is rehearsed by ``tests/test_torch_routing.py``), the kernel row
    stubbed: every check passes but the two that count K2's launches,
    which only the card makes."""
    import chip_smoke
    from porqua_tpu_torch.ops import admm_kernel

    monkeypatch.setattr(chip_smoke, "FAILURES", [])
    monkeypatch.setattr(chip_smoke, "LOAD_CLASSIC", ())
    monkeypatch.setattr(chip_smoke, "LOAD_CONTINUOUS", (
        "device_lost", "probe_blackhole", "queue_stall", "noisy_neighbor",
        "solver_route_flap"))
    monkeypatch.setattr(chip_smoke, "kernel_row", lambda *a: None)
    monkeypatch.setattr(admm_kernel, "dense_form", lambda *a: "cluster")
    added = chip_smoke.load_driver_phase({}, lambda: None, device="cpu")
    assert added == ["load_k2"]
    failed = chip_smoke.FAILURES
    assert len(failed) == 2, failed
    assert failed[0].startswith("[load] K2 launched in the fault-free")
    assert failed[1].startswith("[load] the drivers' cells launched K2")


def test_oracle_requests_match_the_jax_package():
    """The 16 requests and their oracle answers of ``_build_requests``,
    both packages in f64: equal problems, answers within 1e-8."""
    import jax.numpy as jnp

    from porqua_tpu.qp.canonical import CanonicalQP as JaxQP
    from porqua_tpu.qp.solve import SolverParams
    from porqua_tpu_torch.qp.canonical import CanonicalQP

    def f64(cls, dtype):
        build = cls.build
        return staticmethod(lambda *a, **k: build(*a, **{**k,
                                                         "dtype": dtype}))

    jparams = SolverParams(max_iter=500, eps_abs=1e-5, eps_rel=1e-5,
                           polish=False, check_interval=25)
    params = twin("calibration_smoke").reference_params()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxQP, "build", f64(JaxQP, jnp.float64))
        mp.setattr(CanonicalQP, "build", f64(CanonicalQP, torch.float64))
        jqps, jrefs = jax_script("chaos_suite")._build_requests(16, jparams)
        qps, refs = twin("chaos_suite")._build_requests(16, params)
    assert len(refs) == len(jrefs) == 16
    for jq, q in zip(jqps, qps):
        for a, b in zip(jq, q):
            if a is not None:
                assert b.dtype == torch.float64
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_allclose(np.stack(refs), np.stack(jrefs), rtol=0,
                               atol=1e-8)


# ---------------------------------------------------------------------------
# the breaker pair on the CPU
# ---------------------------------------------------------------------------

def test_breaker_pair_opens_and_recloses_on_two_cpu_labels():
    """``probe_blackhole`` on (``cpu:1``, ``cpu``): the startup probes
    fail, the breaker opens and its window is served on ``cpu:0``; it
    re-closes, and the last recovery round is served on ``cpu:1``."""
    from porqua_tpu_torch.cli import Tally

    chaos = twin("chaos_suite")
    primary, fallback = chaos.breaker_pair("cpu")
    assert (str(primary), str(fallback)) == ("cpu:1", "cpu")
    tally = Tally()
    verdict = port_cell("probe_blackhole", "classic", tally)
    assert_reference("probe_blackhole", verdict)
    kinds = verdict["event_kinds"]
    assert kinds["breaker_open"] >= 1 and kinds["breaker_close"] >= 1
    assert verdict["invariants"]["breaker_cycle"]["detail"]["device"] == \
        "cpu:1"
    phases = tally.cells[-1]["phases"]
    window = [d for rnd in phases["window"]["rounds"] for d in rnd]
    assert "cpu:0" in window
    assert set(phases["recovery"]["rounds"][-1]) == {"cpu:1"}
    assert set(tally.cells[-1]["resolutions"]) == {1}


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DRIVERS)
def test_help_is_the_jax_scripts_plus_device(name, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        twin(name).main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    opts = re.findall(r"^  (?:-\w+, )?(--[\w-]+)", text, re.M)
    assert set(opts) - {"--help"} == jax_options(name) | {"--device"}
    assert opts[-1] == "--device"


@pytest.mark.parametrize("name", DRIVERS)
def test_twins_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(name).main(["--seed", "0"])


# ---------------------------------------------------------------------------
# the rest of the matrix, both packages side by side
# ---------------------------------------------------------------------------

REST = [(name, mode) for name in VERDICTS for mode in ("classic",
                                                       "continuous")
        if (name, mode) not in {(c, "classic") for c in TIER1.values()}]


@pytest.mark.slow
@pytest.mark.parametrize("name,mode", REST)
def test_matrix_cell_matches_the_jax_script(name, mode):
    """Every other cell of the JAX matrix (and the promote drill in both
    modes): the JAX function's verdict and the twin's on the same seed
    have the same keys and invariant names, all true, and equal
    ``VERDICTS``."""
    want = jax_cell(name, mode)
    got = port_cell(name, mode)
    assert shape(got) == shape(want)
    assert_reference(name, want)
    assert_reference(name, got)
