"""The port's ``profiling.py`` against the JAX package's on the same
inputs: the analytic ADMM cost model over a grid of its options (equal
to the float), the roofline report with no known card, the solve
rollup of one solution, and the serve metrics' bridge into a Tracer;
then, on the CPU alone, the stage timer, the steady-state timers and
the profiler bridge (a Chrome trace written)."""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from porqua_tpu import profiling as jprof
from porqua_tpu.serve.metrics import ServeMetrics as JaxMetrics

from porqua_tpu_torch import profiling
from porqua_tpu_torch.serve.metrics import ServeMetrics


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small problems gain nothing from intra-op threads beside the
    suite's other workers (see tests/test_torch_scan.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRID = list(itertools.product(
    ("trinv", "chol", "inverse", "woodbury"),      # linsolve
    ("ruiz", "factored"),                          # scaling_mode
    (False, True),                                 # pallas
    (0, 1),                                        # woodbury_refine
    (None, 260)))                                  # polish_k


@pytest.mark.parametrize("linsolve, scaling_mode, pallas, refine, polish_k",
                         GRID)
def test_admm_flop_model_matches_jax(linsolve, scaling_mode, pallas, refine,
                                     polish_k):
    for n, m, window, iters, n_dates, segments in (
            (500, 1, 252, 37.5, 252, None), (24, 3, 0, 100.0, 1, 7.0)):
        kw = dict(segments=segments, check_interval=25, scaling_iters=10,
                  scaling_mode=scaling_mode, pallas=pallas,
                  polish_passes=3, polish_refine_steps=3,
                  l1_kkt_solves=2 if polish_k else 1, linsolve=linsolve,
                  woodbury_refine=refine, polish_k=polish_k)
        mine = profiling.admm_flop_model(n, m, window, iters, n_dates, **kw)
        ref = jprof.admm_flop_model(n, m, window, iters, n_dates, **kw)
        assert mine == ref
    with pytest.raises(ValueError, match="scaling_mode"):
        profiling.admm_flop_model(8, 1, 4, 25.0, scaling_mode="jacobi")


@pytest.mark.parametrize("linsolve", ["trinv", "woodbury"])
def test_roofline_report_matches_jax(linsolve):
    """No known card: the achieved rates, equal; with the card's name
    the MFU fields read against the H100's data-sheet peaks, f32 for
    the compute wall (TF32 off)."""
    model = profiling.admm_flop_model(512, 8, 252, 25.0, 256,
                                      linsolve=linsolve)
    for seconds in (0.0025, 1.5):
        assert profiling.roofline_report(model, seconds) == \
            jprof.roofline_report(model, seconds)
    kind = "NVIDIA H100 80GB HBM3"
    assert profiling.device_peaks(kind) == (989e12, 3.35e12)
    assert profiling.device_f32_peak(kind) == 67e12
    assert profiling.device_peaks("TPU v5 lite") == (None, None)
    assert profiling.device_peaks("") == (None, None)
    card = profiling.roofline_report(model, 0.01, kind)
    flops = model["flops_total"] / 0.01
    assert card["mfu_f32_est"] == flops / 67e12
    assert card["mfu_bf16_peak"] == flops / 989e12
    assert card["hbm_utilization"] == model["bytes_total"] / 0.01 / 3.35e12
    assert card["roofline_seconds_min"] == max(
        model["flops_total"] / 67e12, model["bytes_total"] / 3.35e12)


def test_solve_stats_matches_jax():
    rng = np.random.default_rng(3)
    status = np.array([1, 1, 2, 3, 4, 1, 0], np.int32)
    fields = dict(status=status,
                  iters=rng.integers(25, 400, 7).astype(np.int32),
                  prim_res=rng.random(7).astype(np.float32),
                  dual_res=rng.random(7).astype(np.float32))

    class Sol:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    mine = profiling.solve_stats(Sol(**{k: torch.from_numpy(v)
                                        for k, v in fields.items()}))
    assert mine == jprof.solve_stats(Sol(**fields))
    assert mine["solved"] == 3 and mine["n_problems"] == 7


def test_bridge_tracer_matches_jax():
    """ServeMetrics' window into a Tracer: the same three stages with
    the same seconds and meta."""
    out = []
    for metrics_cls, mod in ((ServeMetrics, profiling), (JaxMetrics, jprof)):
        m = metrics_cls()
        for s in (0.002, 0.004):
            m.observe_queue_wait(s)
        m.observe_batch(3, 4, 0.0125, 37.5)
        m.observe_compile(0.5)
        tracer = mod.Tracer()
        m.bridge_tracer(tracer)
        out.append([(t.name, t.seconds, t.meta) for t in tracer.timings])
    assert out[0] == out[1]
    assert [name for name, _, _ in out[0]] == [
        "serve/queue_wait", "serve/solve", "serve/compile"]


def test_tracer_stage_and_report():
    """Host and device stages; the report's lines and totals; a stage
    that raises is still recorded."""
    tracer = profiling.Tracer()
    with tracer.stage("build", note="host"):
        pass
    with tracer.stage("solve") as holder:
        holder["value"] = {"x": torch.ones(3)}
    with pytest.raises(RuntimeError):
        with tracer.stage("fail"):
            raise RuntimeError("boom")
    assert [t.name for t in tracer.timings] == ["build", "solve", "fail"]
    assert tracer.timings[0].meta == {"note": "host"}
    assert set(tracer.as_dict()) == {"build", "solve", "fail"}
    assert tracer.total() == pytest.approx(sum(tracer.as_dict().values()))
    assert tracer.report().splitlines()[-1].startswith("total")
    assert [d["name"] for d in json.loads(tracer.to_json())] == [
        "build", "solve", "fail"]


def test_timers_and_device_trace_on_the_cpu(tmp_path):
    """The steady-state timers run ``fn`` on perturbed inputs and report
    non-negative seconds; ``device_trace`` writes a Chrome trace."""
    seen = []

    def fn(a):
        seen.append(float(a["x"][0, 0]))
        return torch.matmul(a["x"], a["y"])

    f64 = torch.float64       # 1e-7 steps above 1 are distinct in f64
    base = {"x": torch.ones(16, 16, dtype=f64),
            "y": torch.ones(16, 16, dtype=f64), "n": torch.arange(3)}
    stages = profiling.timed_stages(fn, base)
    assert set(stages) == {"trace_lower", "compile", "execute_first",
                           "execute"}
    assert stages["trace_lower"] == 0.0 and min(stages.values()) >= 0.0
    assert seen[-1] != seen[0]          # the last run saw perturbed inputs
    seen.clear()
    med, runs, out = profiling.measure_device(fn, base, n_runs=3)
    assert len(runs) == 3 and med in runs and out.shape == (16, 16)
    assert len(set(seen)) == 4          # every run perturbed differently
    per, floor = profiling.measure_steady_state(
        lambda a: fn(a).sum(), base, k=3, n_runs=2, return_floor=True)
    assert per >= 0.0 and floor >= 0.0
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)
