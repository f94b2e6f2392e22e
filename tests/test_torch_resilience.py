"""The port's fault injector against the JAX package's: the same
``Scenario``, seed and sequence of seam hits fire the same faults, with
the same directives and the same seeded draws, in both packages."""

import numpy as np
import pytest
import torch

from porqua_tpu.resilience import faults as jfaults

import porqua_tpu_torch as pt
from porqua_tpu_torch.resilience import faults


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PACKAGES = {"port": faults, "jax": jfaults}


def replay(mod, scenario_of, hits=12):
    """Drive every seam ``hits`` times in a fixed round-robin order and
    record what each hit did: nothing, a raised fault, or a directive
    with its args and two draws from the rule's own generator."""
    scenario = scenario_of(mod)
    trace = []
    with mod.active(scenario) as inj:
        for i in range(hits):
            for seam in mod.SEAMS:
                try:
                    act = mod.fire(seam, idx=i)
                except mod.InjectedFault:
                    trace.append((seam, i, "InjectedFault"))
                    continue
                except mod.InjectedCrash:
                    trace.append((seam, i, "InjectedCrash"))
                    continue
                if act is None:
                    trace.append((seam, i, None))
                else:
                    trace.append((seam, i, act.kind, sorted(act.args.items()),
                                  act.rng.random(2).tolist()))
        return trace, inj.log(), inj.fires(), inj.exhausted()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(faults.builtin_scenarios()))
def test_builtin_scenarios_replay_identically(name, seed):
    assert sorted(faults.builtin_scenarios(seed)) == sorted(
        jfaults.builtin_scenarios(seed))
    port = replay(faults, lambda m: m.builtin_scenarios(seed)[name])
    ref = replay(jfaults, lambda m: m.builtin_scenarios(seed)[name])
    assert port == ref
    assert port[2] > 0 and port[3]


@pytest.mark.parametrize("p", [0.3, 1.0])
def test_probabilistic_crash_replays_identically(p):
    """A seeded p < 1 rule draws the same stream in both packages."""
    def scenario_of(mod):
        return mod.Scenario("crashy", (
            mod.FaultSpec.make("backtest.chunk", "crash", start=2, count=3,
                               p=p),
            mod.FaultSpec.make("loadgen.worker", "crash", count=2, p=p),
        ), seed=11)

    assert replay(faults, scenario_of, 20) == replay(jfaults, scenario_of, 20)


@pytest.mark.parametrize("bad", [
    dict(seam="nope", kind="crash"),
    dict(seam="backtest.chunk", kind="nope"),
    dict(seam="serve.dispatch", kind="crash"),
    dict(seam="backtest.chunk", kind="crash", count=0),
    dict(seam="backtest.chunk", kind="crash", p=0.0),
])
def test_fault_spec_typing_rejects_the_same(bad):
    for mod in PACKAGES.values():
        with pytest.raises(ValueError):
            mod.FaultSpec.make(**bad)


def test_install_is_exclusive_and_context_managed():
    scenario = faults.Scenario("s", (faults.FaultSpec.make(
        "backtest.chunk", "crash"),))
    assert not faults.enabled()
    with faults.active(scenario):
        assert faults.enabled()
        with pytest.raises(RuntimeError, match="already installed"):
            faults.install(faults.FaultInjector(scenario))
    assert not faults.enabled()
    assert faults.fire("backtest.chunk") is None


def test_fault_clock():
    port, ref = faults.FaultClock(1.5), jfaults.FaultClock(1.5)
    for dt in (0.25, 3.0, 0.0):
        assert port.advance(dt) == ref.advance(dt)
        assert port() == ref()


def test_corrupt_feed_poisons_a_copy_of_the_tensors():
    n = 6
    qp = pt.CanonicalQP.build(np.eye(n), np.arange(n, dtype=float),
                              np.ones((1, n)), np.ones(1), np.ones(1),
                              np.zeros(n), np.ones(n), dtype=torch.float64,
                              device="cpu")
    q_before = qp.q.clone()
    for lanes in (None, 3):
        args = {} if lanes is None else {"lanes": lanes}
        act = faults.FaultAction("feed_corrupt", args,
                                 np.random.default_rng(0))
        bad = faults.corrupt_feed(qp, act)
        ref = jfaults.corrupt_feed(qp._replace(q=qp.q.numpy()),
                                   jfaults.FaultAction(
                                       "feed_corrupt", args,
                                       np.random.default_rng(0)))
        np.testing.assert_array_equal(torch.isnan(bad.q).numpy(),
                                      np.isnan(ref.q))
        assert torch.isnan(bad.q).sum() == (lanes or 1)
        assert torch.equal(qp.q, q_before)
        assert bad.P is qp.P
