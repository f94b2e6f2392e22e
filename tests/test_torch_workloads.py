"""The port's workload library (``porqua_tpu_torch/serve/workloads.py``)
against the JAX package's on the same specs and seeds: arrival traces,
per-tenant problem pools and merged blends are equal bit for bit (both
draw from numpy's PCG64 keyed per (seed, tenant)), and the port's own
``selftest()`` passes."""

import numpy as np
import pytest

from porqua_tpu.serve import workloads as jw

import porqua_tpu_torch as pt
from porqua_tpu_torch.serve import workloads as tw

SPEC = ("alpha:tracking:diurnal:rate=40,amplitude=0.5,period_s=20,"
        "n_assets=12,window=32,pool=4;"
        "beta:lad:heavy_tailed:rate=15,n_assets=8,window=32,pool=3;"
        "gamma:turnover:bursty:rate=8,burst_factor=10,n_assets=6,"
        "window=32,pool=3,offender=1,quota=64,weight=2;"
        "delta:tracking:steady:rate=5,n_assets=6,window=32,pool=2")


def assert_same_qp(tq, jq):
    for name, a, b in zip(pt.CanonicalQP._fields, jq, tq):
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
            assert b.numpy().dtype == np.asarray(a).dtype, name


def test_specs_parse_the_same():
    assert tw.parse_tenant_specs(SPEC) == tuple(
        tw.TenantSpec(**{f: getattr(s, f) for f in s.__dataclass_fields__})
        for s in jw.parse_tenant_specs(SPEC))
    with pytest.raises(ValueError, match="unknown tenant-spec key"):
        tw.parse_tenant_specs("a:tracking:steady:nope=1")


@pytest.mark.parametrize("name", ["alpha", "beta", "gamma", "delta"])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_match_jax(name, seed):
    spec = {s.name: s for s in tw.parse_tenant_specs(SPEC)}[name]
    jspec = {s.name: s for s in jw.parse_tenant_specs(SPEC)}[name]
    got = tw.arrival_times(spec, 30.0, seed=seed)
    want = jw.arrival_times(jspec, 30.0, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["alpha", "beta", "gamma"])
def test_problem_pools_match_jax(name):
    spec = {s.name: s for s in tw.parse_tenant_specs(SPEC)}[name]
    jspec = {s.name: s for s in jw.parse_tenant_specs(SPEC)}[name]
    got, want = tw.build_problems(spec, seed=3), jw.build_problems(jspec,
                                                                   seed=3)
    assert len(got) == len(want) == spec.pool
    for tq, jq in zip(got, want):
        assert tq.q.device.type == "cpu"
        assert_same_qp(tq, jq)


def test_blend_matches_jax():
    got = tw.build_blend(tw.parse_tenant_specs(SPEC), 12.0, seed=5)
    want = jw.build_blend(jw.parse_tenant_specs(SPEC), 12.0, seed=5)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.tenants == want.tenants
    assert got.shares() == want.shares()
    assert got.quota_map() == want.quota_map() == {"gamma": 64}
    assert got.weight_map() == want.weight_map() == {"gamma": 2.0}
    assert got.offenders() == want.offenders() == ["gamma"]
    for tq, jq in zip(got.requests, want.requests):
        assert_same_qp(tq, jq)


def test_selftest_passes():
    tw.selftest()
