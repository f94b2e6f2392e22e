"""The port's analysis plane (``porqua_tpu_torch.analysis``): the AST
rules restated for torch (GC001-GC005, GC007) on seeded snippets, the
port tree scanning clean, the op-trace contracts (GC101-GC111) clean on
every entry point and catching seeded violations, the
``PORQUA_SANITIZE=1`` transfer guard with its controls (and guarded
runs bit-equal to unguarded ones), the compile bookkeeping, and the
parity of the public surface with the JAX package's.
"""

import os
import re
import textwrap

import numpy as np
import pytest
import torch

import porqua_tpu_torch as pt
from porqua_tpu_torch.analysis import contracts, hlo, sanitize
from porqua_tpu_torch.analysis.lint import RULE_DOCS, scan_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "porqua_tpu_torch")
JAX_PKG = os.path.join(ROOT, "porqua_tpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def findings_for(tmp_path, relpath, source, rules=None, roots=None):
    path = tmp_path / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return [(f.rule, f.line) for f in scan_paths([str(path)], rules=rules,
                                                 roots=roots)]


# ---------------------------------------------------------------------------
# the public surface against the JAX package's
# ---------------------------------------------------------------------------

def test_rule_ids_and_all_equal_the_jax_packages():
    import porqua_tpu.analysis as jan
    import porqua_tpu.parallel as jpar
    from porqua_tpu.analysis.lint import RULE_DOCS as JAX_DOCS

    import porqua_tpu_torch.analysis as pan
    import porqua_tpu_torch.parallel as ppar

    assert set(RULE_DOCS) == set(JAX_DOCS)
    assert pan.__all__ == jan.__all__
    assert ppar.__all__ == jpar.__all__
    for name in pan.__all__:
        assert getattr(pan, name) is not None
    from porqua_tpu_torch.analysis import hlolint

    assert hlolint.HLO_RULES == tuple(r for r in sorted(RULE_DOCS)
                                      if r.startswith("GC2"))


def test_every_jax_module_has_a_port_counterpart():
    missing = []
    for root, dirs, names in os.walk(JAX_PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in names:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), JAX_PKG)
                if not os.path.exists(os.path.join(PORT, rel)):
                    missing.append(rel)
    assert missing == []


def test_nothing_left_unported():
    for root, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert "_not_ported(" not in f.read(), name
    # The serving dispatch sites catch the sanitizer's error alone.
    for rel in ("serve/batcher.py", "serve/continuous.py"):
        with open(os.path.join(PORT, rel)) as f:
            src = f.read()
        assert "NotImplementedError" not in src
        assert len(re.findall(r"except sanitize\.SanitizerError as exc:",
                              src)) >= 1


# ---------------------------------------------------------------------------
# the port tree
# ---------------------------------------------------------------------------

def test_port_tree_scans_clean_with_zero_suppressions():
    stats = {}
    findings = scan_paths([PORT], stats_out=stats)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert stats["files"] > 80
    assert stats["suppressions_by_rule"] == {}


def test_declared_roots_exist():
    from porqua_tpu_torch.analysis.lint import HOT_ROOTS, load_module

    for rel, names in HOT_ROOTS.items():
        mod = load_module(os.path.join(PORT, rel))
        for name in names:
            assert name in mod.defs_by_name, (rel, name)


# ---------------------------------------------------------------------------
# GC001 — precision
# ---------------------------------------------------------------------------

GC001_CASES = {
    "tf32_flag": ("util.py", """\
        import torch

        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = False
        """, [("GC001", 3)]),
    "matmul_precision": ("util.py", """\
        import torch

        def setup(mode):
            torch.set_float32_matmul_precision("high")
            torch.set_float32_matmul_precision(mode)
            torch.set_float32_matmul_precision("highest")
        """, [("GC001", 4), ("GC001", 5)]),
    "policy_class_exempt": ("qp/canonical.py", """\
        import torch

        class _PrecisionPolicy:
            def apply(self, on):
                torch.backends.cuda.matmul.allow_tf32 = on

        class Other:
            def apply(self, on):
                torch.backends.cuda.matmul.allow_tf32 = on
        """, [("GC001", 9)]),
    "half_casts_in_scope": ("qp/mod.py", """\
        import torch
        from torch import bfloat16

        def f(x):
            a = x.half()
            b = x.to(torch.float16)
            c = torch.zeros(3, dtype=bfloat16)
            d = x.to(torch.float32)
            with torch.autocast("cuda"):
                return a, b, c, d
        """, [("GC001", 5), ("GC001", 6), ("GC001", 7), ("GC001", 9)]),
    "half_casts_outside_scope": ("serve/mod.py", """\
        import torch

        def f(x):
            return x.half(), x.to(torch.bfloat16)
        """, []),
    "triton_dot": ("ops/kern.py", """\
        import triton.language as tl

        def body(a, b):
            x = tl.dot(a, b)
            y = tl.dot(a, b, input_precision="ieee")
            z = tl.dot(a, b, allow_tf32=False)
            return x + y + z
        """, [("GC001", 4)]),
}


@pytest.mark.parametrize("case", sorted(GC001_CASES))
def test_gc001_precision(tmp_path, case):
    rel, src, want = GC001_CASES[case]
    assert findings_for(tmp_path, rel, src, rules={"GC001"}) == want


# ---------------------------------------------------------------------------
# GC002 — host syncs in hot code
# ---------------------------------------------------------------------------

ROOTS = {"qp/admm.py": ("_make_segment",)}


def test_gc002_flags_reads_reachable_from_a_root(tmp_path):
    (tmp_path / "qp").mkdir()
    (tmp_path / "qp" / "ops.py").write_text(textwrap.dedent("""\
        import torch

        def build_operator(K):
            scale = K.abs().max().item()        # hidden read: flagged
            return K / scale

        def host_report(x):
            return x.cpu().numpy()              # not reachable: clean
        """))
    hits = findings_for(tmp_path, "qp/admm.py", """\
        import torch
        from qp.ops import build_operator
        from porqua_tpu_torch.analysis import sanitize

        def _make_segment(qp, params, n: int):
            K = build_operator(qp)
            m = int(qp.shape[0]) + int(n) + int(params.check_interval)
            def segment(x):
                torch.cuda.synchronize()
                return bool(x.any()), float(x.sum()), x.tolist()
            return segment

        def run_segments(x):
            while True:
                with sanitize.explicit_transfer():
                    running = bool(x.any())
                if not running:
                    break
                if bool(x.all()):
                    break
        """, rules={"GC002"}, roots=ROOTS)
    ops = str(tmp_path / "qp" / "ops.py")
    found = [(f.rule, os.path.basename(f.path), f.line) for f in scan_paths(
        [str(tmp_path)], rules={"GC002"}, roots=ROOTS)]
    assert ("GC002", "ops.py", 4) in found
    assert ("GC002", "ops.py", 8) not in found
    assert hits == [("GC002", 9), ("GC002", 10), ("GC002", 10),
                    ("GC002", 10)]
    assert os.path.exists(ops)


def test_gc002_loop_driver_read_is_declared_not_flagged(tmp_path):
    # The loop driver is no root; as a root, only its undeclared read
    # is flagged.
    src = """\
        from porqua_tpu_torch.analysis import sanitize

        def run_segments(active, step):
            while True:
                with sanitize.explicit_transfer():
                    running = bool(active.any())
                if not running:
                    break
                active = step(active)
                if active.sum().item() > 3:
                    break
        """
    assert findings_for(tmp_path, "qp/admm.py", src, rules={"GC002"},
                        roots=ROOTS) == []
    assert findings_for(tmp_path, "qp/admm.py", src, rules={"GC002"},
                        roots={"qp/admm.py": ("run_segments",)}) == \
        [("GC002", 10)]


def test_gc002_default_roots_cover_the_segment_path():
    from porqua_tpu_torch.analysis.lint import HOT_ROOTS

    assert "_make_segment" in HOT_ROOTS["qp/admm.py"]
    assert "run_segments" not in HOT_ROOTS["qp/admm.py"]
    assert "step_and_repack" in HOT_ROOTS["compaction.py"]
    assert "_finalize_impl" in HOT_ROOTS["qp/solve.py"]


# ---------------------------------------------------------------------------
# GC003 — recompiles and kernel builds
# ---------------------------------------------------------------------------

def test_gc003_compiles_in_loops_and_steady_state(tmp_path):
    hits = findings_for(tmp_path, "serve/mod.py", """\
        import functools
        import torch
        from torch.utils import cpp_extension

        FAST = torch.compile(lambda x: x + 1)      # module scope: clean

        def per_call(fn):
            return torch.compile(fn)               # steady state: flagged

        @functools.lru_cache(maxsize=None)
        def cached(fn):
            return torch.jit.script(fn)            # cached: clean

        class Entry:
            def __init__(self, fn):
                self.fn = torch.compile(fn)        # on self: clean

        def loop(fns):
            for fn in fns:
                g = torch.cuda.CUDAGraph()         # in a loop: flagged
            return cpp_extension.load("k", ["k.cu"])  # not _build: flagged
        """, rules={"GC003"})
    assert hits == [("GC003", 8), ("GC003", 20), ("GC003", 21)]


def test_gc003_builder_module_may_build(tmp_path):
    src = """\
        from torch.utils.cpp_extension import load

        def build(name):
            return load(name, [name + ".cu"])
        """
    assert findings_for(tmp_path, "ops/_build.py", src,
                        rules={"GC003"}) == []
    assert findings_for(tmp_path, "misc.py", src, rules={"GC003"}) == \
        [("GC003", 4)]


# ---------------------------------------------------------------------------
# GC004 / GC005 / GC007
# ---------------------------------------------------------------------------

def test_gc004_debug_hooks(tmp_path):
    hits = findings_for(tmp_path, "qp/mod.py", """\
        import pdb
        import torch

        def f(x):
            breakpoint()
            pdb.set_trace()
            torch.autograd.set_detect_anomaly(True)
            with torch.autograd.detect_anomaly():
                return x
        """, rules={"GC004"})
    assert hits == [("GC004", 5), ("GC004", 6), ("GC004", 7), ("GC004", 8)]
    assert findings_for(tmp_path, "scripts/tool.py",
                        "breakpoint()\n", rules={"GC004"}) == []


def test_gc005_cuda_work_at_import(tmp_path):
    hits = findings_for(tmp_path, "ops/mod.py", """\
        import torch
        from porqua_tpu_torch.ops import _build

        torch.cuda.init()
        DEV = torch.cuda.current_device()
        ONES = torch.ones(3, device="cuda")
        TWOS = torch.ones(3).cuda()
        LIB = _build.build("admm_segment")
        OK = torch.cuda.is_available()
        CPU = torch.ones(3, device="cpu")

        def lazy(device="cuda:0"):
            torch.cuda.synchronize()
            return torch.ones(3, device="cuda")

        if OK:
            def also_lazy():
                return torch.ones(3).to("cuda")
        """, rules={"GC005"})
    assert hits == [("GC005", 4), ("GC005", 5), ("GC005", 6), ("GC005", 7),
                    ("GC005", 8)]


def test_gc007_seams_need_the_enabled_guard(tmp_path):
    hits = findings_for(tmp_path, "serve/bad.py", """\
        from porqua_tpu_torch.resilience import faults as _faults

        def dispatch(batch):
            _faults.fire("serve.dispatch")          # unguarded: flagged
            if _faults.enabled():
                _faults.fire("serve.dispatch")      # guarded: clean
            else:
                _faults.fire("serve.dispatch")      # orelse: flagged
            if not _faults.enabled():
                _faults.fire("serve.dispatch")      # negated: flagged
            return batch
        """, rules={"GC007"})
    assert hits == [("GC007", 4), ("GC007", 8), ("GC007", 10)]


def test_line_and_file_suppressions(tmp_path):
    assert findings_for(tmp_path, "qp/a.py", """\
        def f(x):
            breakpoint()  # graftcheck: disable=GC004
        """, rules={"GC004"}) == []
    assert findings_for(tmp_path, "qp/b.py", """\
        # graftcheck: disable-file=GC004
        def f(x):
            breakpoint()
        """, rules={"GC004"}) == []


# ---------------------------------------------------------------------------
# the transfer guard
# ---------------------------------------------------------------------------

def test_guard_off_costs_nothing(monkeypatch):
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    monkeypatch.delenv("PORQUA_SANITIZE", raising=False)
    x = torch.ones(3)
    with sanitize.transfer_guard():
        assert _get_current_dispatch_mode() is None
        assert x.sum().item() == 3.0           # not enforced
        x.to("meta")


def test_guard_controls(monkeypatch):
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    x = torch.ones(3)
    cases = {
        "item": lambda: x.sum().item(),
        "bool": lambda: bool(x.any()),
        "float": lambda: float(x.sum()),
        "copy to another device": lambda: x.to("meta"),
        "copy_ from another device": lambda: torch.empty(
            3, device="meta").copy_(x),
        "operands on two devices": lambda: torch.add(
            torch.ones(3, device="meta"), x),
    }
    for name, fn in cases.items():
        with pytest.raises(sanitize.SanitizerError, match="implicit "
                           "transfer"):
            with sanitize.transfer_guard():
                fn()
    with sanitize.transfer_guard():
        y = (x * 2 + torch.tensor(1.0)).sum(dim=0)   # 0-dim CPU scalar: ok
        with sanitize.explicit_transfer():
            assert y.item() == 9.0
            assert x.to("meta").device.type == "meta"
        assert x.to(torch.float64).dtype == torch.float64  # same device
    with pytest.raises(ValueError, match="level"):
        with sanitize.transfer_guard("log"):
            pass


def test_guard_nests_with_the_cost_counter(monkeypatch):
    from porqua_tpu_torch.obs import devprof

    fn, args = contracts.solve_batch_program(device="cpu")
    monkeypatch.delenv("PORQUA_SANITIZE", raising=False)
    bare_out, bare = devprof.count_call(fn, *args)
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    with sanitize.transfer_guard():
        out, counted = devprof.count_call(fn, *args)
    assert counted.op_hash == bare.op_hash
    assert (counted.flops, counted.bytes_accessed, counted.segments) == \
        (bare.flops, bare.bytes_accessed, bare.segments)
    assert all(torch.equal(a, b) for a, b in zip(out, bare_out)
               if a is not None)


def hidden(monkeypatch, kind):
    """The seeded control: the solve's finalize makes a hidden host read
    (``item``) or takes an operand on another device (``meta``)."""
    import porqua_tpu_torch.qp.solve as solve_mod

    real = solve_mod._finalize_impl

    def bad(*a, **k):
        sol = real(*a, **k)
        if kind == "item":
            sol.x.sum().item()
            return sol
        torch.add(sol.x, torch.zeros(sol.x.shape, device="meta"))
        return sol

    monkeypatch.setattr(solve_mod, "_finalize_impl", bad)


def tracking_problems(n_dates=6):
    from porqua_tpu_torch.batch import BatchProblems

    Xs, ys = pt.synthetic_universe_np(42, n_dates, 40, 16)
    qp = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
    return BatchProblems(qp=qp, rebdates=[str(i) for i in range(n_dates)],
                         universes=[[]] * n_dates, n_assets_max=16)


def same_solution(a, b):
    return all((u is None and v is None) or torch.equal(u, v)
               for u, v in zip(a, b))


@pytest.mark.parametrize("linsolve", ["woodbury", "trinv"])
def test_guarded_solve_batch_bit_equal_and_control(monkeypatch, linsolve):
    from porqua_tpu_torch.batch import solve_batch

    problems = tracking_problems()
    params = pt.SolverParams(backend="pallas", linsolve=linsolve,
                             eps_abs=1e-3, eps_rel=1e-3)
    monkeypatch.setenv("PORQUA_SANITIZE", "0")
    bare = solve_batch(problems, params, device="cpu")
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    guarded = solve_batch(problems, params, device="cpu")
    assert same_solution(guarded, bare)
    hidden(monkeypatch, "item")
    with pytest.raises(sanitize.SanitizerError, match="host read"):
        solve_batch(problems, params, device="cpu")


def test_guarded_compaction_bit_equal_and_control(monkeypatch):
    from porqua_tpu_torch.compaction import CompactingDriver

    qp = tracking_problems(8).qp
    params = pt.SolverParams(backend="pallas", linsolve="woodbury",
                             eps_abs=1e-5, eps_rel=1e-5)
    driver = CompactingDriver(params, device="cpu")
    monkeypatch.setenv("PORQUA_SANITIZE", "0")
    bare, rep = driver.solve(qp)
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    guarded, rep2 = driver.solve(qp)
    assert same_solution(guarded, bare)
    assert rep2.dispatch_sizes == rep.dispatch_sizes
    hidden(monkeypatch, "meta")
    with pytest.raises(sanitize.SanitizerError, match="several devices"):
        driver.solve(qp)


@pytest.mark.parametrize("continuous", [False, True])
def test_guarded_serving_bit_equal_and_control(monkeypatch, continuous):
    """A burst through SolveService under the guard answers the same
    bits as without it; the control (a hidden read in the guarded
    dispatch) fails its batch and leaves the breaker closed."""
    from porqua_tpu_torch.serve import SolveService

    qps = [pt.qp.CanonicalQP(*(None if f is None else f[i]
                               for f in tracking_problems(8).qp))
           for i in range(8)]
    params = pt.SolverParams(eps_abs=1e-4, eps_rel=1e-4, max_iter=400,
                             polish=False)
    svc = SolveService(params, max_batch=8, max_wait_ms=60000.0,
                       warm_start=False, continuous=continuous,
                       device="cpu")

    def burst():
        tickets = [svc.submit(q) for q in qps]
        out = []
        for t in tickets:
            try:
                out.append(svc.result(t, timeout=120))
            except Exception as exc:  # noqa: BLE001 - the control's
                out.append(exc)
        return out

    with svc:
        svc.prewarm(qps[0])
        monkeypatch.setenv("PORQUA_SANITIZE", "0")
        off = burst()
        monkeypatch.setenv("PORQUA_SANITIZE", "1")
        on = burst()
        hidden(monkeypatch, "item")
        bad = burst()
        snap = svc.snapshot()
    for a, b in zip(on, off):
        assert np.array_equal(a.x, b.x) and a.status == b.status \
            and a.iters == b.iters
    assert all(isinstance(r, Exception) and "sanitizer" in str(r).lower()
               for r in bad)
    assert not snap["degraded"] and snap["dispatch_failures"] == 0


# ---------------------------------------------------------------------------
# compile bookkeeping
# ---------------------------------------------------------------------------

def make_qp(n=6, m=2, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((2 * n, n))
    P = A.T @ A / (2 * n) + np.eye(n)
    q = rng.standard_normal(n)
    C = np.concatenate([np.ones((1, n)), rng.standard_normal((m - 1, n))])
    return pt.CanonicalQP.build(
        P, q, C=C, l=np.full(m, -1.0), u=np.ones(m),
        lb=np.zeros(n), ub=np.ones(n), device="cpu")


def test_sanitizer_zero_recompiles_after_warmup(monkeypatch):
    from porqua_tpu_torch.serve import BucketLadder, SolveError, SolveService

    params = pt.SolverParams(max_iter=300, eps_abs=1e-4, eps_rel=1e-4,
                             polish=False, check_interval=25)
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    sanitize.reset()
    try:
        ladder = BucketLadder(n_rungs=(8, 16), m_rungs=(4,))
        svc = SolveService(params=params, ladder=ladder, max_batch=2,
                           max_wait_ms=1.0, device="cpu")
        with svc:
            compiled = svc.prewarm(make_qp())
            assert compiled >= 1
            assert sanitize.compile_count() >= compiled
            res = svc.solve(make_qp(seed=1), timeout=120)
            assert res.found
            assert sanitize.post_warmup_compiles() == 0
            with pytest.raises(SolveError, match="compile after warmup"):
                svc.solve(make_qp(n=12, seed=2), timeout=120)
            assert sanitize.post_warmup_compiles() >= 1
            assert not svc.health.degraded
            assert svc.solve(make_qp(seed=3), timeout=120).found
    finally:
        sanitize.reset()


def test_sanitizer_counters_run_without_enforcement(monkeypatch):
    monkeypatch.delenv("PORQUA_SANITIZE", raising=False)
    sanitize.reset()
    try:
        sanitize.note_compile("probe")
        assert sanitize.compile_count() == 1
        sanitize.warmup_complete()
        sanitize.note_compile("probe")  # counted, not raised
        assert sanitize.post_warmup_compiles() == 1
        with sanitize.no_recompile():
            pass
    finally:
        sanitize.reset()


# ---------------------------------------------------------------------------
# the op-trace contracts
# ---------------------------------------------------------------------------

def _programs():
    return {label: (fn, args) for label, fn, args in
            hlo.entry_point_programs(device="cpu")}


PROGRAM_LABELS = sorted(hlo.load_baseline()["programs"])


@pytest.mark.parametrize("label", PROGRAM_LABELS)
def test_contracts_clean_on_every_entry_point(label):
    fn, args = _programs()[label]
    rec = contracts.trace_program(label, fn, args)
    assert contracts.check_op_trace(rec, label) == []
    # The solves read exactly once per segment boundary.
    if label.startswith(("solve_batch", "serve_entry", "tracking_step")):
        assert rec.declared_reads == rec.segments + 1 >= 2


IDENTITY = ["check_resilience_identity", "check_telemetry_identity",
            "check_observability_identity", "check_devprof_identity",
            "check_federation_identity", "check_tenancy_identity",
            "check_routing_identity", "check_calibration_identity"]


@pytest.mark.parametrize("check", IDENTITY)
def test_identity_contracts_clean(check):
    findings = getattr(contracts, check)(device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)


def test_check_entry_points_runs_every_check(monkeypatch):
    seen = []
    for name in IDENTITY:
        monkeypatch.setattr(contracts, name,
                            lambda name=name, **kw: seen.append(name) or [])
    monkeypatch.setattr(contracts, "_check",
                        lambda label, pair, expect, device:
                        seen.append(label) or [])
    assert contracts.check_entry_points(device="cpu") == []
    labels = set(seen)
    assert set(IDENTITY) <= labels
    assert set(PROGRAM_LABELS) - {"tracking_step[sketch]"} <= labels


def test_contracts_detect_seeded_violations():
    x = torch.ones(4)

    def bad(a):
        y = a.to(torch.float64) * 2.0                # GC101
        z = a.sum().item()                           # GC102: undeclared
        m = a.to("meta")                             # GC102: a copy
        return y, a.half() + z, torch.arange(4), m   # GC103: f64, f16

    rec = contracts.trace_program("bad", bad, (x,))
    found = contracts.check_op_trace(rec, "bad")
    rules = [f.rule for f in found]
    assert rules.count("GC101") >= 1
    assert rules.count("GC102") == 2
    assert rules.count("GC103") == 2

    def reads(a):
        with sanitize.explicit_transfer():
            return [bool(a.any()) for _ in range(3)], a
    rec = contracts.trace_program("reads", reads, (x,))
    assert rec.declared_reads == 3 and rec.segments == 0
    assert [f.rule for f in contracts.check_op_trace(rec, "reads")] == \
        ["GC102"]


def test_identity_contract_catches_a_plane_that_perturbs(monkeypatch):
    """A harvest sink whose emit leaves state that changes what the
    next solve runs is exactly what GC105 exists to catch."""
    import porqua_tpu_torch.qp.solve as solve_mod
    from porqua_tpu_torch.obs.harvest import HarvestSink

    state = {"on": False}
    real_emit = HarvestSink.emit
    real_fin = solve_mod._finalize_impl

    def emit(self, rec):
        state["on"] = True
        return real_emit(self, rec)

    def fin(*a, **k):
        sol = real_fin(*a, **k)
        return sol._replace(x=sol.x * 1.0) if state["on"] else sol

    monkeypatch.setattr(HarvestSink, "emit", emit)
    monkeypatch.setattr(solve_mod, "_finalize_impl", fin)
    found = contracts.check_telemetry_identity(device="cpu")
    assert [f.rule for f in found] == ["GC105"]
    assert "HarvestSink.emit" in found[0].message


def test_contracts_run_batch_clean(rng):
    from tests.test_torch_backtest import make_market, rebdates_of, service
    from porqua_tpu_torch import builders as tb

    data = make_market(rng, n_assets=6, n_days=260)
    bs = service(pt, tb, data, rebdates_of(data, k=3),
                 pt.LeastSquares(), 60)
    findings = contracts.check_run_batch(bs, device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)
