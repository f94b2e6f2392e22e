"""The port's CUDA kernels on the card. Every test here is marked
``gpu`` and skips without a CUDA device. The file imports no JAX, so it
runs on a machine that has only torch:

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py sets up JAX). It also holds
the small kernel inputs that tests/test_torch_admm_kernel.py feeds the
Pallas kernels on the CPU.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import porqua_tpu_torch as pt
from porqua_tpu_torch.ops import admm_kernel as tk

# The kernel forms of the small inputs, and the inputs themselves: the
# kernel call of a small tracking batch (chip_smoke.py holds the same
# calls at the ragged widths in its phase 3).
FORMS = chip_smoke.SMALL_FORMS
kernel_inputs = chip_smoke.small_kernel_call
# Each output's scale: the state vector it belongs to
# (x, z, w, y, mu, dx, dy, dmu).
SCALE_OF = (0, 1, 2, 3, 4, 0, 3, 4)
TWIN = {tk.admm_segment: tk.admm_segment_ref,
        tk.admm_segment_factored: tk.admm_segment_factored_ref}


def f32_floor(kw):
    """Two f32 ulps per iteration of the segment: the rounding budget
    of the increments (dx, dy, dmu), differences of nearly equal
    iterates, beyond the kernel-vs-twin ratio."""
    return 2 * kw["n_iters"] * 2.0 ** -23


def cluster_bytes(n, m, k, refine):
    """admm_segment_cluster.cu's shared memory per block (smem_floats),
    in bytes."""
    ld = (-(-n // 8) + 3) // 4 * 4     # slice width, rounded up to 4
    floats = (k * ld * (2 if refine > 0 else 1) + 17 * ld + 2 * m * ld
              + 8 * ld + 4 + 3 * k + 16 * m + 8 * m + m * m)
    return 4 * floats


def cluster_global_bytes(n, m, k, refine):
    """admm_segment_cluster.cu's smem_floats<true>, the device-memory
    form's shared memory per block, in bytes: a block's slices of the
    n-vectors and of the warps' partials, the partial buffers, the
    replicated m-vectors and receive slots, and C x0 and its Ginv
    product in f64. No operator slice, so ``refine`` does not enter."""
    def round4(v):
        return (v + 3) // 4 * 4
    ld = (-(-n // 8) + 3) // 4 * 4
    floats = (17 * ld + 8 * ld + 4 + round4(k) + 2 * round4(max(k, 2 * m))
              + 16 * m + 8 * m)
    return 4 * (floats + floats % 2 + 4 * m)


def stream_bytes(n, m, k):
    """admm_segment.cu's smem_floats(factored=true), in bytes: the
    dense form's vectors, then C, the factored vectors, t, Y0, Ginv."""
    return dense_stream_bytes(n, m) + 4 * (m * n + 5 * n + k + n * m + m * m)


def dense_stream_bytes(n, m):
    """admm_segment.cu's smem_floats(factored=false), in bytes: the
    vectors alone (C stays in device memory)."""
    return 4 * (14 * n + 10 * m)


# cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100.
H100_SMEM = 232448
# admm_segment_dense_cluster.cu's kStages: the tail's float4 row-steps
# in flight per thread, 256 threads a block.
TAIL_STAGES = 8


def _dense_layout_bytes(n, m, triangular, ranks, rows=None, ring=0):
    """admm_segment_dense_cluster.cu's Layout::total in bytes: L^-1's
    packed lower columns j = r (mod ranks), or ``rows`` rows (default
    n) of K^-1's ceil(n / ranks) consecutive columns and a ring of
    ``ring`` floats, then the vectors, C's slice and the exchange
    buffers."""
    def round4(v):
        return (v + 3) // 4 * 4
    nc = -(-n // ranks)
    ld, n4 = round4(nc), round4(n)
    rows = n if rows is None else rows
    op = (round4(nc * n - ranks * nc * (nc - 1) // 2) if triangular
          else rows * ld + ring)
    # exchange buffers, then the reduce-scatter slots of t (triangular,
    # at least a staged 32 x 33 set-up tile) or the warps' partials
    if triangular:
        work = max(2 * n4 + round4(2 * ranks * nc), 32 * 33)
    else:
        work = 2 * n4 + 8 * ld
    floats = op + 13 * ld + m * ld + work + 12 + 2 * ranks * m + 7 * m
    return 4 * floats


def dense_cluster_ranks(n, m, triangular, limit=H100_SMEM):
    """admm_segment_dense_cluster.cu's rank count (tri_ranks): L^-1 on
    8 blocks where a rank's share fits ``limit``, else 16; K^-1 on 16."""
    if triangular and _dense_layout_bytes(n, m, True, 8) <= limit:
        return 8
    return 16


def dense_cluster_bytes(n, m, triangular, limit=H100_SMEM):
    """admm_segment_dense_cluster.cu's shared memory per block of the
    resident cluster form, at the rank count it takes on a card of
    ``limit`` bytes a block."""
    return _dense_layout_bytes(n, m, triangular,
                               dense_cluster_ranks(n, m, triangular, limit))


def dense_tail_rows(n, m, triangular, limit=H100_SMEM):
    """admm_segment_dense_cluster.cu's tail_rows: the rows of each
    rank's K^-1 slice the tail form keeps in shared memory, at most n;
    -1 for L^-1, where the rest does not fit ``limit`` or where the
    slice is wider than 128 columns."""
    ld = (-(-n // 16) + 3) // 4 * 4
    base = _dense_layout_bytes(n, m, False, 16, rows=0,
                               ring=TAIL_STAGES * 256 * 4)
    if triangular or ld > 128 or base > limit:
        return -1
    return min(n, (limit - base) // (4 * ld))


def dense_tail_bytes(n, m, triangular, limit=H100_SMEM):
    """The tail form's shared memory per block (2**31 - 1 where it
    does not exist at this shape)."""
    rows = dense_tail_rows(n, m, triangular, limit)
    if rows < 0:
        return 2 ** 31 - 1
    return _dense_layout_bytes(n, m, False, 16, rows=rows,
                               ring=TAIL_STAGES * 256 * 4)


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def factored_counts():
    return counts_of(tk.admm_segment_factored)


def counts_of(wrapper):
    return wrapper.launches, wrapper.cluster_launches, wrapper.stream_launches


def tail_count():
    return tk.admm_segment.tail_launches


def assert_matches_twin(fn, out, args, kw, beside=None):
    """chip_smoke.py's twin rule: per output, the kernel's distance to
    the twin run in f64 is at most 4x the twin's f32 rounding noise
    (its largest distance over chip_smoke.TWIN_ORDERS: the batch on the
    card and on the CPU, the lanes reversed, lane by lane), plus two f32
    ulps of the output's scale per iteration. ``beside``: the outputs
    of another f32 implementation on the same inputs, which joins the
    noise."""
    ref = chip_smoke.twin_reference(TWIN[fn], args, kw)
    margins, _ = chip_smoke.twin_margins(out, ref, kw, beside=beside)
    for i, (ok, e_k, noise, scale) in enumerate(margins):
        assert ok, (chip_smoke.OUT_NAMES[i], e_k, noise, scale,
                    {k: v[i] for k, v in ref["orders"].items()})


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_kernel_matches_plain_twin(form):
    """The kernel against its twin in f32, held as chip_smoke.py holds
    it: per output, its distance to the twin run in f64 is at most 4x
    the f32 twin's own, plus two f32 ulps of the output's scale per
    iteration."""
    need_card()
    fn, args, kw = kernel_inputs(form, np.float32)
    args = tuple(a.cuda() for a in args)
    before = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == before + 1
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37])
def test_cluster_kernel_matches_plain_twin(n, m, refine):
    """The 8-block cluster form at shapes that stress its column
    partition: n=5 leaves ranks 5-7 without a column, 13 and 37 leave
    the last ranks ragged. Each launch moves the cluster counter by one
    and the streaming counter not at all. Held by the twin rule, with
    the streaming kernel's outputs on the same inputs beside the twin's:
    at n=5 the budget row's dual moves by rho (z_pre - 1), where z_pre
    is rounded at an ulp of 1, not of y, and on the card the f32 twin's
    dy came 10x nearer the f64 answer than either kernel's (2.6e-9
    against 2.35e-8 for both, y's scale 1.25e-3), which the floor of two
    ulps of y per iteration (1.0e-8) does not cover."""
    need_card()
    fn, args, kw = kernel_inputs("factored_refine0", np.float32, n=n, m=m,
                                 refine=refine)
    args = tuple(a.cuda() for a in args)
    k = args[0].shape[-2]
    assert tk.factored_form(n, m, k, refine) == "cluster"
    launches, cluster, stream = factored_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert factored_counts() == (launches + 1, cluster + 1, stream)
    streamed = tk._admm_segment_factored_form("stream", *args, **kw)
    assert_matches_twin(fn, out, args, kw, beside=streamed)


@pytest.mark.gpu
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("n, k", [(2048, 256), (512, 1024)])
def test_factored_shape_beyond_cluster_goes_to_stream(n, k, refine):
    """2,048 assets at k=256 and 512 at k=1024: a block's slice of W
    (256 x 256 or 1024 x 64 floats, with V beside it when refining) is
    above the shared-memory limit, so the streaming form runs. The long
    window sums W' t over 1,024 rows, which the streaming form sums in
    blocks so as to stay within the twin rule."""
    need_card()
    fn, args, kw = kernel_inputs("factored_refine0", np.float32, n=n,
                                 window=k, batch=2, refine=refine)
    args = tuple(a.cuda() for a in args)
    assert tk.factored_form(n, 1, k, refine) == "stream"
    launches, cluster, stream = factored_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert factored_counts() == (launches + 1, cluster, stream + 1)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["cluster", "stream"])
def test_named_factored_form_matches_plain_twin(form):
    """Both forms at one shape through the private entry that
    chip_smoke.py times them with."""
    need_card()
    fn, args, kw = kernel_inputs("factored_refine1", np.float32, n=37)
    args = tuple(a.cuda() for a in args)
    launches, cluster, stream = factored_counts()
    out = tk._admm_segment_factored_form(form, *args, **kw)
    torch.cuda.synchronize()
    assert factored_counts() == (launches + 1, cluster + (form == "cluster"),
                                 stream + (form == "stream"))
    assert_matches_twin(fn, out, args, kw)


DENSE = {True: "triangular", False: "inverse"}


def dense_call(triangular, n, m, n_iters):
    """A dense kernel call on the card at n assets and m rows, with the
    segment cut or stretched to ``n_iters`` iterations."""
    fn, args, kw = kernel_inputs(DENSE[triangular], np.float32, n=n, m=m)
    assert fn is tk.admm_segment and kw["triangular"] == triangular
    return fn, tuple(a.cuda() for a in args), dict(kw, n_iters=n_iters)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37, 500])
@pytest.mark.parametrize("triangular", [True, False])
def test_dense_cluster_kernel_matches_plain_twin(triangular, n, m, n_iters):
    """The dense cluster forms at the widths where the router takes them
    (L^-1 over 8 ranks, K^-1 over 16), at shapes that stress their
    column partitions: n=5 and 13 leave ranks
    without a column, 37 leaves the last ranks ragged, 500 is the
    headline width. Each launch moves the cluster counter by one and
    the streaming counter not at all. Held by the twin rule over the
    twin's summation orders: on the duals (y, dy, mu, dmu) at small n
    the twin's one run on the card came up to 2,700x nearer the f64
    answer than its run on the CPU (scripts/torch_twin_margins.py prints
    each order's distance)."""
    need_card()
    fn, args, kw = dense_call(triangular, n, m, n_iters)
    assert tk.dense_form(n, m, triangular) == "cluster"
    launches, cluster, stream = counts_of(fn)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert counts_of(fn) == (launches + 1, cluster + 1, stream)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37])
@pytest.mark.parametrize("triangular", [True, False])
def test_dense_stream_kernel_matches_plain_twin(triangular, n, m, n_iters):
    """The streaming dense form (segment_kernel<false>) at the ragged
    widths where the router sends nothing to it but where it is the
    fallback of a shape whose cluster form does not fit: n=5, 13 and
    37, one and three rows, one iteration and a whole segment. Each
    launch moves the streaming counter by one and the cluster counter
    not at all; held by the twin rule."""
    need_card()
    fn, args, kw = dense_call(triangular, n, m, n_iters)
    launches, cluster, stream = counts_of(fn)
    out = tk._admm_segment_form("stream", *args, **kw)
    torch.cuda.synchronize()
    assert counts_of(fn) == (launches + 1, cluster, stream + 1)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37])
def test_factored_stream_kernel_matches_plain_twin(n, m, refine, n_iters):
    """The streaming factored form (segment_kernel<true>) at the
    cluster tests' shapes, through the private entry, with one
    iteration and a whole segment; held by the twin rule."""
    need_card()
    fn, args, kw = kernel_inputs("factored_refine0", np.float32, n=n, m=m,
                                 refine=refine)
    args = tuple(a.cuda() for a in args)
    kw = dict(kw, n_iters=n_iters)
    launches, cluster, stream = factored_counts()
    out = tk._admm_segment_factored_form("stream", *args, **kw)
    torch.cuda.synchronize()
    assert factored_counts() == (launches + 1, cluster, stream + 1)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("triangular", [True, False])
def test_dense_shape_beyond_cluster_goes_to_stream(triangular):
    """Beyond both cluster forms: L^-1 at 1,400 assets (a 16th of its
    packed columns, 269 KB, is above the shared-memory limit) and K^-1
    at 1,024 x 512 (C's slice and the receive buffers alone, 251 KB,
    leave no room for resident rows): the streaming form runs and
    matches the twin."""
    need_card()
    n, m = (1400, 1) if triangular else (1024, 512)
    fn, args, kw = dense_call(triangular, n, m, 25)
    assert tk.dense_form(n, m, triangular) == "stream"
    launches, cluster, stream = counts_of(fn)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert counts_of(fn) == (launches + 1, cluster, stream + 1)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["cluster", "stream"])
@pytest.mark.parametrize("triangular", [True, False])
def test_named_dense_form_matches_plain_twin(triangular, form):
    """Both dense forms at one shape through the private entry that
    chip_smoke.py times them with, each held by the twin rule."""
    need_card()
    fn, args, kw = dense_call(triangular, 37, 1, 25)
    launches, cluster, stream = counts_of(fn)
    out = tk._admm_segment_form(form, *args, **kw)
    torch.cuda.synchronize()
    assert counts_of(fn) == (launches + 1, cluster + (form == "cluster"),
                             stream + (form == "stream"))
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
def test_dense_cluster_smem_size_is_the_one_the_router_reads():
    """The dense sizes the CPU routing tests assume
    (tests/test_torch_dense_route.py) are the C functions' own."""
    need_card()
    stream_lib = tk._library(tk._LIB)
    dense_lib = tk._library(tk._DENSE_LIB)
    limit = stream_lib.porqua_max_smem_optin()
    for n, m in [(5, 1), (13, 3), (37, 3), (500, 1), (1024, 1)]:
        for tri in (True, False):
            assert dense_lib.porqua_admm_dense_cluster_smem_bytes(
                n, m, int(tri)) == dense_cluster_bytes(n, m, tri, limit)
        assert stream_lib.porqua_admm_segment_smem_bytes(
            0, n, m, 0) == dense_stream_bytes(n, m)


@pytest.mark.gpu
def test_dense_layouts_are_the_ones_the_router_reads():
    """The rank count, resident rows and shared-memory sizes of the
    dense cluster forms that the router and the traffic model read are
    the ones the launchers use, and the CPU mirror's, at the ragged
    widths, the tracking width and the service's wide rungs; the tail
    form exists for K^-1 only."""
    need_card()
    lib = tk._library(tk._DENSE_LIB)
    limit = tk._library(tk._LIB).porqua_max_smem_optin()
    for n, m in [(5, 1), (13, 3), (37, 3), (500, 1), (1024, 1), (1024, 128),
                 (512, 512), (1024, 512), (1400, 1), (2048, 8)]:
        for tri in (True, False):
            assert lib.porqua_admm_dense_cluster_ranks(n, m, int(tri)) == \
                dense_cluster_ranks(n, m, tri, limit), (n, m, tri)
            assert lib.porqua_admm_dense_cluster_smem_bytes(
                n, m, int(tri)) == dense_cluster_bytes(n, m, tri, limit)
            assert lib.porqua_admm_dense_tail_rows(n, m, int(tri)) == \
                dense_tail_rows(n, m, tri, limit), (n, m, tri)
            assert lib.porqua_admm_dense_tail_smem_bytes(
                n, m, int(tri)) == dense_tail_bytes(n, m, tri, limit)
            if dense_tail_bytes(n, m, tri, limit) <= limit:
                assert lib.porqua_admm_dense_tail_max_active(
                    n, m, int(tri)) > 0
    assert lib.porqua_admm_dense_cluster_ranks(1024, 128, 1) == 16
    assert lib.porqua_admm_dense_tail_rows(1024, 128, 1) == -1
    fn, args, kw = dense_call(True, 37, 1, 25)
    with pytest.raises(RuntimeError, match="launch failed"):
        tk._admm_segment_form("tail", *args, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37, 100])
@pytest.mark.parametrize("triangular", [True, False])
def test_wide_dense_instances_match_plain_twin(triangular, n, m, n_iters):
    """The instances the wide rungs run, forced at ragged widths: L^-1
    on 16 ranks (n = 5 and 13 leave ranks without a column), and K^-1
    with a streamed tail that holds none, half or all of each rank's
    rows in shared memory (the ring wraps across iterations; n = 100
    keeps several row-steps per pass). Each launch moves its form's
    counter by one; held by the twin rule."""
    need_card()
    fn, args, kw = dense_call(triangular, n, m, n_iters)
    layouts = ([dict(ranks=16)] if triangular
               else [dict(rows=r) for r in (0, n // 2, n)])
    for layout in layouts:
        form = "cluster" if triangular else "tail"
        before, tails = counts_of(fn), tail_count()
        out = tk._admm_segment_form(form, *args, **kw, **layout)
        torch.cuda.synchronize()
        assert counts_of(fn) == (before[0] + 1, before[1] + triangular,
                                 before[2])
        assert tail_count() == tails + (not triangular)
        assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("triangular", [True, False])
def test_named_dense_forms_at_the_rung(triangular):
    """The (1024, 128) rung at phase 8e's batch of 8: each form that
    takes it, launched by name (the one-block form and the 16-rank
    cluster, or the tail for K^-1), matches the twin."""
    need_card()
    fn, args, kw = dense_call(triangular, 1024, 128, 25)
    args = tuple(a[:1].expand(8, *a.shape[1:]).contiguous() for a in args)
    forms = ["stream", "cluster" if triangular else "tail"]
    assert tk.dense_form(1024, 128, triangular) == forms[1]
    for form in forms:
        out = tk._admm_segment_form(form, *args, **kw)
        torch.cuda.synchronize()
        assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
def test_cluster_smem_size_is_the_one_the_router_reads():
    """The shared-memory sizes the CPU routing tests assume
    (tests/test_torch_cluster_route.py) are the C functions' own."""
    need_card()
    stream_lib = tk._library(tk._LIB)
    cluster_lib = tk._library(tk._CLUSTER_LIB)
    for n, m, k in [(5, 1, 24), (37, 3, 24), (500, 1, 252), (2048, 1, 256)]:
        for refine in (0, 1, 2):
            assert cluster_lib.porqua_admm_cluster_smem_bytes(
                n, m, k, refine) == cluster_bytes(n, m, k, refine)
        assert stream_lib.porqua_admm_segment_smem_bytes(
            1, n, m, k) == stream_bytes(n, m, k)


@pytest.mark.gpu
def test_gap_smem_sizes_are_the_ones_the_router_reads():
    """The sizes the CPU routing tests assume for the forms that serve
    the shapes no cluster form fits (cluster_global_bytes,
    dense_stream_bytes) are the C functions' own, at the ragged widths,
    the ladder's rungs and the sketch shape."""
    need_card()
    stream_lib = tk._library(tk._LIB)
    cluster_lib = tk._library(tk._CLUSTER_LIB)
    for n, m, k in [(5, 1, 24), (37, 3, 24), (500, 1, 252), (1024, 128, 252),
                    (2048, 512, 252), (5000, 1, 256), (5888, 1, 252)]:
        for refine in (0, 1):
            assert cluster_lib.porqua_admm_cluster_global_smem_bytes(
                n, m, k, refine) == cluster_global_bytes(n, m, k, refine)
    for n, m in [(5, 1), (37, 3), (512, 512), (1024, 128), (1664, 2048)]:
        assert stream_lib.porqua_admm_segment_smem_bytes(
            0, n, m, 0) == dense_stream_bytes(n, m)


def global_counts(wrapper):
    return wrapper.launches, wrapper.global_launches


@pytest.mark.gpu
@pytest.mark.parametrize("n_iters", [1, 25])
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [5, 13, 37])
def test_factored_global_kernel_matches_plain_twin(n, m, refine, n_iters):
    """The factored device-memory form (cluster_kernel<true>) at the
    cluster tests' shapes, through the private entry, with one
    iteration and a whole segment; each launch moves its counter by
    one. Held by the twin rule, with the cluster form's outputs on the
    same inputs beside the twin's (as the cluster test holds it)."""
    need_card()
    fn, args, kw = kernel_inputs("factored_refine0", np.float32, n=n, m=m,
                                 refine=refine)
    args = tuple(a.cuda() for a in args)
    kw = dict(kw, n_iters=n_iters)
    launches, held = global_counts(fn)
    out = tk._admm_segment_factored_form("global", *args, **kw)
    torch.cuda.synchronize()
    assert global_counts(fn) == (launches + 1, held + 1)
    clustered = tk._admm_segment_factored_form("cluster", *args, **kw)
    assert_matches_twin(fn, out, args, kw, beside=clustered)


@pytest.mark.gpu
@pytest.mark.parametrize("refine, n, m, k", [(0, 5000, 1, 256),
                                             (1, 2048, 8, 252)])
def test_factored_gap_shape_goes_to_global(refine, n, m, k):
    """The sketch-fed 5,000-asset north star (k = 256, B = 1) and the
    ladder's 2,048 x 8 rung at a year's window with refinement: no
    cluster slice and no streaming block fits, so the router picks the
    device-memory form, which matches the twin."""
    need_card()
    fn, args, kw = kernel_inputs("factored_refine0", np.float32, n=n, m=m,
                                 window=k, batch=1, refine=refine)
    args = tuple(a.cuda() for a in args)
    assert tk.factored_form(n, m, k, refine) == "global"
    launches, held = global_counts(fn)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert global_counts(fn) == (launches + 1, held + 1)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("n, m", [(1024, 128), (512, 512)])
@pytest.mark.parametrize("triangular", [True, False])
def test_dense_gap_shape_matches_plain_twin(triangular, n, m):
    """The ladder's 1,024 x 128 rung (L^-1 goes to the 16-rank cluster,
    K^-1 to the cluster with a streamed tail) and 512 x 512 (L^-1 on
    16 ranks; K^-1's 16-block cluster fits): the routed form matches
    the twin."""
    need_card()
    fn, args, kw = dense_call(triangular, n, m, 25)
    form = tk.dense_form(n, m, triangular)
    assert form == ("tail" if (n, m, triangular) == (1024, 128, False)
                    else "cluster")
    before, tails = counts_of(fn), tail_count()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert counts_of(fn) == (before[0] + 1,
                             before[1] + (form == "cluster"),
                             before[2])
    assert tail_count() == tails + (form == "tail")
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back():
    """float64 and a problem above the shared-memory limit are refused
    on the card (no plain fallback)."""
    need_card()
    fn, args, kw = kernel_inputs("inverse", np.float64)
    with pytest.raises(TypeError, match="float32"):
        fn(*(a.cuda() for a in args), **kw)
    B, n, m = 1, 6000, 1
    f = lambda *s: torch.zeros((B,) + s, device="cuda")
    # q l u lb ub rho rho_b l1w l1c x z w y mu
    sizes = (n, m, m, n, n, m, n, n, n, n, m, n, m, n)
    big = (f(n, n), f(m, n)) + tuple(f(s) for s in sizes)
    with pytest.raises(ValueError, match="shared memory"):
        tk.admm_segment(*big, **kw)


@pytest.mark.gpu
def test_factored_wrapper_raises_where_no_form_fits():
    """60,000 assets fit neither a cluster block's slice nor the
    streaming form's block: the wrapper raises before any launch."""
    need_card()
    B, n, m, k = 1, 60000, 1, 1
    f = lambda *s: torch.zeros((B,) + s, device="cuda")
    # W inv_d Y0 Ginv V Dv C q l u lb ub rho rho_b l1w l1c x z w y mu
    args = (f(k, n), f(n), f(n, m), f(m, m), f(k, n), f(n), f(m, n), f(n),
            f(m), f(m), f(n), f(n), f(m), f(n), f(n), f(n), f(n), f(m), f(n),
            f(m), f(n))
    before = factored_counts()
    with pytest.raises(ValueError, match="shared memory"):
        tk.admm_segment_factored(*args, sigma=1e-6, alpha=1.6, n_iters=2)
    assert factored_counts() == before


def scan_kernel_inputs(form, lanes, device, n=40, window=24, n_dates=3):
    """The kernel call that date 2 of a small chained L1 scan makes on
    ``device`` (the scaled L1 weight and center, the warm carry of date
    1): one lane for the factored form, a grid of ``lanes`` benchmark
    columns over one universe for the dense ones."""
    from porqua_tpu_torch import batch as tbatch
    from porqua_tpu_torch.tracking import benchmark_grid_np

    params = pt.SolverParams(max_iter=2000, eps_abs=1e-3, eps_rel=1e-3,
                             polish=False, scaling_iters=2, backend="pallas",
                             **FORMS[form])
    Xs, ys = pt.synthetic_universe_np(13, n_dates, window, n)
    cols = [pt.build_tracking_qp(torch.as_tensor(Xs, device=device),
                                 torch.as_tensor(y, device=device))
            for y in benchmark_grid_np(Xs, ys, lanes)]
    qp = pt.CanonicalQP(*(None if f[0] is None else torch.stack(f)
                          for f in zip(*cols)))
    pt.qp.canonical.HP.apply()
    w0 = torch.full((lanes, n), 1.0 / n, device=device)
    l1w = tbatch._l1_weight(n, n, 0.002, torch.float32, device)
    return chip_smoke.scan_kernel_call(qp, w0, l1w, params, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("form, lanes", [("factored_refine0", 1),
                                         ("triangular", 8)])
def test_scan_kernel_call_matches_plain_twin(form, lanes):
    """The chained scans' kernel calls on the card: K1 in its cluster
    form at one lane (solve_scan_l1), K2 in its cluster form at 8 lanes
    (solve_scan_l1_grid), each with the L1 term on and the warm carry
    of the chain. One launch of the cluster form each, held by the
    twin rule."""
    need_card()
    fn, args, kw = scan_kernel_inputs(form, lanes, "cuda")
    n, m = args[-1].shape[-1], args[-4].shape[-1]
    assert args[-1].shape[0] == lanes
    for v in args[-7:-5] + args[-5:-1]:   # l1w, l1c, x, z, w, y
        assert float(v.abs().max()) > 0
    if fn is tk.admm_segment:
        assert tk.dense_form(n, m, kw["triangular"]) == "cluster"
    else:
        assert tk.factored_form(n, m, args[0].shape[-2], 0) == "cluster"
    launches, cluster, stream = counts_of(fn)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert counts_of(fn) == (launches + 1, cluster + 1, stream)
    assert_matches_twin(fn, out, args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS))
def test_tracking_step_on_card_matches_cpu(form):
    """The whole slice on the card against the CPU run (plain twins):
    same status and iterations per lane."""
    need_card()
    Xs, ys = pt.synthetic_universe_np(7, 4, 40, 16)
    params = pt.SolverParams(max_iter=2000, eps_abs=1e-5, eps_rel=1e-5,
                             polish=False, scaling_iters=2,
                             backend="pallas", **FORMS[form])
    cpu = pt.tracking_step(Xs, ys, params, device="cpu")
    card = pt.tracking_step(Xs, ys, params, device="cuda")
    assert card.status.cpu().tolist() == cpu.status.tolist()
    assert card.iters.cpu().tolist() == cpu.iters.tolist()
    np.testing.assert_allclose(card.weights.cpu().numpy(),
                               cpu.weights.numpy(), atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS))
def test_tracking_step_on_card_goes_through_cluster(form):
    """Every config (both woodbury ones, trinv and inverse) runs its
    segments on its cluster kernel and never on the streaming one, and
    agrees with the CPU run."""
    need_card()
    Xs, ys = pt.synthetic_universe_np(7, 4, 40, 16)
    params = pt.SolverParams(max_iter=2000, eps_abs=1e-5, eps_rel=1e-5,
                             polish=False, scaling_iters=2,
                             backend="pallas", **FORMS[form])
    cpu = pt.tracking_step(Xs, ys, params, device="cpu")
    wrapper = (tk.admm_segment_factored if form.startswith("factored")
               else tk.admm_segment)
    launches, cluster, stream = counts_of(wrapper)
    card = pt.tracking_step(Xs, ys, params, device="cuda")
    torch.cuda.synchronize()
    after = counts_of(wrapper)
    assert after[1] > cluster and after[2] == stream
    assert after[0] - launches == after[1] - cluster
    assert card.status.cpu().tolist() == cpu.status.tolist()
    assert card.iters.cpu().tolist() == cpu.iters.tolist()
    np.testing.assert_allclose(card.weights.cpu().numpy(),
                               cpu.weights.numpy(), atol=1e-4, rtol=0)


def small_backtest(optimization, n_assets=8, n_days=300, width=120,
                   n_dates=4, seed=5):
    """A BacktestService over a seeded market (a window longer than the
    universe, so each date's optimum is a point) and its frames."""
    import pandas as pd
    from porqua_tpu_torch import builders as tb

    rng = np.random.default_rng(seed)
    dates = pd.bdate_range("2020-01-01", periods=n_days)
    X = pd.DataFrame(rng.standard_normal((n_days, n_assets)) * 0.01,
                     index=dates, columns=[f"A{i}" for i in range(n_assets)])
    bm = pd.DataFrame({"bm": X.to_numpy() @ rng.dirichlet(np.ones(n_assets))
                       + rng.standard_normal(n_days) * 0.001}, index=dates)
    rebdates = [str(d.date()) for d in dates[150::30][:n_dates]]
    bs = pt.BacktestService(
        data={"return_series": X, "bm_series": bm},
        selection_item_builders={
            "data": pt.SelectionItemBuilder(bibfn=tb.bibfn_selection_data)},
        optimization_item_builders={
            "returns": pt.OptimizationItemBuilder(
                bibfn=tb.bibfn_return_series, width=width),
            "bm": pt.OptimizationItemBuilder(
                bibfn=tb.bibfn_bm_series, width=width, align=True),
            "budget": pt.OptimizationItemBuilder(
                bibfn=tb.bibfn_budget_constraint),
            "box": pt.OptimizationItemBuilder(
                bibfn=tb.bibfn_box_constraints, upper=0.3)},
        optimization=optimization,
        settings={"rebdates": rebdates, "quiet": True})
    return bs, X, bm


@pytest.mark.gpu
@pytest.mark.parametrize("polish", [True, False])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_run_batch_on_card_matches_cpu(form, polish):
    """The batched backtest with the library-default polish on the card
    (kernels) against the CPU run (plain twins): same status and
    iterations per date, weights within 1e-4, and it goes through the
    config's kernel."""
    need_card()
    params = pt.SolverParams(eps_abs=1e-4, eps_rel=1e-4, polish=polish,
                             backend="pallas", **FORMS[form])
    cpu = pt.run_batch(small_backtest(pt.LeastSquares())[0], params,
                       device="cpu")
    wrapper = (tk.admm_segment_factored if form.startswith("factored")
               else tk.admm_segment)
    before = counts_of(wrapper)
    card = pt.run_batch(small_backtest(pt.LeastSquares())[0], params,
                        device="cuda")
    assert counts_of(wrapper)[0] > before[0]
    for k in ("status", "iters"):
        assert card.output["batch"][k].tolist() == cpu.output["batch"][k].tolist()
    w_card = card.strategy.get_weights_df().to_numpy(float)
    w_cpu = cpu.strategy.get_weights_df().to_numpy(float)
    np.testing.assert_allclose(w_card, w_cpu, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_serial_backtest_and_accounting_on_card():
    """Backtest.run and simulate_strategy on the card against the CPU
    (f64: the plain path, no kernel)."""
    from porqua_tpu_torch.accounting import simulate_strategy

    need_card()
    runs = {}
    for dev in ("cpu", "cuda"):
        bs, X, bm = small_backtest(pt.MeanVariance(
            dtype=np.float64, eps_abs=1e-8, eps_rel=1e-8, max_iter=20000))
        bt = pt.Backtest()
        bt.run(bs, device=dev)
        runs[dev] = (bt.strategy.get_weights_df().to_numpy(float),
                     simulate_strategy(bt.strategy, X, vc=0.001, fc=0.01,
                                       device=dev).to_numpy())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-7)
    np.testing.assert_allclose(runs["cuda"][1], runs["cpu"][1], atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("continuous", [False, True],
                         ids=["micro", "continuous"])
@pytest.mark.parametrize("kind", ["dense", "factored"])
def test_service_on_card_matches_cpu(kind, continuous):
    """64 tracking requests (60 assets, window 120; bucket 64 x 8)
    through SolveService on the card and on the CPU, in each batching
    mode: equal status and iterations per request, every result
    labelled cuda:0, and the card's run went through the cluster form
    of its kernel and never the streaming one."""
    import dataclasses

    from porqua_tpu_torch.serve import SolveService
    from porqua_tpu_torch.serve.loadgen import (SERVE_PARAMS,
                                                build_tracking_requests)

    need_card()
    factor = kind == "factored"
    reqs = build_tracking_requests(64, n_assets=60, window=120, seed=3,
                                   factor=factor)
    opts = FORMS["factored_refine0" if factor else "triangular"]
    params = dataclasses.replace(SERVE_PARAMS, backend="pallas", **opts)
    wrapper = tk.admm_segment_factored if factor else tk.admm_segment
    results, counts = {}, {}
    for dev in ("cpu", "cuda"):
        before = counts_of(wrapper)
        with SolveService(params, max_batch=16, max_wait_ms=2.0,
                          continuous=continuous, warm_start=False,
                          device=dev) as svc:
            svc.prewarm(reqs[0])
            tickets = [svc.submit(q) for q in reqs]
            results[dev] = [svc.result(t, timeout=300) for t in tickets]
        counts[dev] = [a - b for a, b in zip(counts_of(wrapper), before)]
    assert counts["cuda"][1] > 0 and counts["cuda"][2] == 0
    assert {r.device for r in results["cuda"]} == {"cuda:0"}
    for k in ("status", "iters"):
        assert ([getattr(r, k) for r in results["cuda"]]
                == [getattr(r, k) for r in results["cpu"]]), k
    x_card = np.stack([r.x for r in results["cuda"]])
    x_cpu = np.stack([r.x for r in results["cpu"]])
    np.testing.assert_allclose(x_card, x_cpu, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("continuous", [False, True],
                         ids=["micro", "continuous"])
def test_routed_service_on_card(continuous):
    """A routed, retried and observed service on the card: 64 tracking
    requests (60 assets, bucket 64 x 8) routed to ADMM (the table set
    by a versioned swap), a shadow on a losing backend after the first
    classic dispatch. Every served record says cuda:0 and admm, every
    result solves on cuda:0, the ADMM arm launched K2's cluster form,
    and the shadow lanes solved on a loser; then a route flip to PDHG
    serves the same requests with zero compiles after prewarm."""
    import dataclasses

    from porqua_tpu_torch import obs
    from porqua_tpu_torch.resilience import RetryPolicy
    from porqua_tpu_torch.serve import SolverRouter, SolveService
    from porqua_tpu_torch.serve.loadgen import (SERVE_PARAMS,
                                                build_tracking_requests)

    need_card()
    reqs = build_tracking_requests(64, n_assets=60, window=120, seed=3)
    params = dataclasses.replace(SERVE_PARAMS, backend="pallas",
                                 **FORMS["triangular"])
    router = SolverRouter(params, shadow_rate=1.0, shadow_seed=0,
                          shadow_budget_per_tick=1)
    router.set_table({("64x8", params.eps_abs): "admm"})
    sink = obs.HarvestSink(None)
    before = counts_of(tk.admm_segment)
    with SolveService(params, max_batch=16, max_wait_ms=2.0,
                      continuous=continuous, warm_start=False,
                      router=router, retry=RetryPolicy(),
                      obs=obs.Observability(), harvest=sink,
                      slo=obs.SLOEngine(), device="cuda") as svc:
        n_prewarm = svc.prewarm(reqs[0])
        results = [svc.result(t, timeout=300)
                   for t in [svc.submit(q) for q in reqs]]
        counts = [a - b for a, b in zip(counts_of(tk.admm_segment), before)]
        router.force("pdhg")
        flipped = [svc.solve(q, timeout=300) for q in reqs[:8]]
        snap = svc.snapshot()
    served = [r for r in sink.buffered() if r["source"] != "serve.shadow"]
    shadows = [r for r in sink.buffered() if r["source"] == "serve.shadow"]
    assert counts[1] > 0 and counts[2] == 0
    assert all(r.found and r.device == "cuda:0" for r in results + flipped)
    assert len(served) == 64 + 8
    assert {r["device"] for r in served} == {"cuda:0"}
    assert [r["solver"] for r in served] == ["admm"] * 64 + ["pdhg"] * 8
    assert bool(shadows) != continuous
    assert all(r["solver"] in ("pdhg", "napg") for r in shadows)
    assert snap["compiles"] == n_prewarm


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["factored_refine0", "triangular"])
def test_compacted_solve_on_card_walks_the_ladder(form):
    """A compacted tracking batch (24 dates of 60 assets, eps 1e-4,
    a check every 5 iterations, so the dates retire at 20 to 30
    iterations, the same checks in f32 and f64 on the CPU) on the card:
    the cluster form of the config's kernel launches at two widths or
    more and never the streaming form, no compile after prewarm, and
    status and iterations equal the same compacted solve on the CPU (x
    within 1e-4)."""
    from porqua_tpu_torch.compaction import CompactingDriver

    need_card()
    params = pt.SolverParams(max_iter=2000, eps_abs=1e-4, eps_rel=1e-4,
                             polish=False, scaling_iters=2,
                             backend="pallas",
                             **dict(FORMS[form], check_interval=5))
    Xs, ys = pt.synthetic_universe_np(5, 24, 120, 60)
    qp = pt.build_tracking_qp(torch.as_tensor(Xs), torch.as_tensor(ys))
    wrapper = (tk.admm_segment_factored if form.startswith("factored")
               else tk.admm_segment)
    out = {}
    for dev in ("cpu", "cuda"):
        driver = CompactingDriver(params, device=dev)
        driver.prewarm(24, 60, 1, factor_rows=120)
        before = counts_of(wrapper)
        wrapper.widths = {}
        sol, rep = driver.solve(qp)
        out[dev] = (sol, rep, [a - b for a, b in zip(counts_of(wrapper),
                                                     before)],
                    dict(wrapper.widths))
    sol, rep, counts, widths = out["cuda"]
    cpu_sol = out["cpu"][0]
    assert rep.compiles == 0
    assert counts[1] == rep.segments and counts[2] == 0
    assert len(widths) >= 2, widths
    assert torch.equal(sol.status.cpu(), cpu_sol.status)
    assert torch.equal(sol.iters.cpu(), cpu_sol.iters)
    np.testing.assert_allclose(sol.x.cpu().numpy(), cpu_sol.x.numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_sketch_on_card_is_deterministic_and_matches_cpu():
    """The count-sketch of a 504 x 2,048 window on the card: the same
    bits on every call (a dense product, no atomics), equal to the CPU's
    within f32 summation order, and the seeded draws identical on both
    devices."""
    from porqua_tpu_torch.qp.canonical import sketch_draws, sketch_rows
    from porqua_tpu_torch.synthetic import large_universe_np

    need_card()
    pt.qp.canonical.HP.apply()
    X, _ = large_universe_np(7, 504, 2048)
    draws = sketch_draws(504, 256, 3)
    on = draws.to("cuda", torch.float32)
    Xc = torch.as_tensor(X, device="cuda")
    a = sketch_rows(Xc, 256, on.bucket, on.sign)
    for _ in range(3):
        assert torch.equal(sketch_rows(Xc, 256, on.bucket, on.sign), a)
    cpu = sketch_rows(torch.as_tensor(X), 256, draws.bucket, draws.sign)
    np.testing.assert_allclose(a.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-6 * float(cpu.abs().max()))
    assert torch.equal(sketch_draws(504, 256, 3).bucket, draws.bucket)


def diff_grads(form, backend, dtype, device="cuda"):
    """examples/differentiable_tuning.py's loss on a small tracking batch
    (3 dates, 24-day fit windows under 37 assets, so the factored
    adjoint runs; 6 days out of sample) through
    ``solve_qp_batch_diff``: (dL/dtheta per date, dL/dy_fit, status,
    iterations, launches of the form's kernel as (cluster, stream))."""
    from porqua_tpu_torch.qp.diff import solve_qp_batch_diff

    pt.qp.canonical.HP.apply()
    eps = 1e-5 if dtype == torch.float32 else 1e-10
    params = pt.SolverParams(eps_abs=eps, eps_rel=eps, polish=False,
                             scaling_iters=2, max_iter=4000,
                             backend=backend, **FORMS[form])
    Xs, ys = pt.synthetic_universe_np(11, 3, 30, 37)
    on = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Xf, yf, Xo, yo = on(Xs[:, :24]), on(ys[:, :24]), on(Xs[:, 24:]), on(
        ys[:, 24:])
    theta = torch.full((3,), -3.0, dtype=dtype, device=device,
                       requires_grad=True)
    y = yf.clone().requires_grad_(True)
    qp = pt.build_tracking_qp(Xf, y, ridge=10.0 ** theta)
    wrapper = (tk.admm_segment if form == "triangular"
               else tk.admm_segment_factored)
    before = counts_of(wrapper)[1:]
    w = solve_qp_batch_diff(qp, params, device=device)
    r = torch.einsum("btn,bn->bt", Xo, w) - yo
    torch.sqrt(torch.mean(r * r, dim=-1)).mean().backward()
    sol = pt.solve_qp_batch(qp, params, device=device)
    after = counts_of(wrapper)[1:]
    return (theta.grad.double().cpu().numpy(), y.grad.double().cpu().numpy(),
            sol.status.cpu().numpy(), sol.iters.cpu().numpy(),
            tuple(a - b for a, b in zip(after, before)))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["triangular", "factored_refine1"])
def test_diff_through_cluster_kernel_matches_plain_twin(form):
    """solve_qp_batch_diff with backend="pallas" launches the form's
    cluster kernel in its forward; its gradients (per-date dL/dtheta and
    dL/dy) are held against the plain path's on the card by the twin
    rule: their distance to the f64 gradient at most KERNEL_VS_PLAIN
    times the plain f32 path's, plus two f32 ulps per iteration of the
    gradient's scale."""
    need_card()
    th_k, y_k, st_k, it_k, launches = diff_grads(form, "pallas", torch.float32)
    th_p, y_p, st_p, it_p, plain_launches = diff_grads(form, "xla",
                                                       torch.float32)
    th_64, y_64, st_64, _, _ = diff_grads(form, "xla", torch.float64)
    assert launches[0] > 0 and launches[1] == 0, launches
    assert plain_launches == (0, 0)
    assert (st_k == 1).all() and (st_p == 1).all() and (st_64 == 1).all()
    for got, plain, ref in ((th_k, th_p, th_64), (y_k, y_p, y_64)):
        floor = 2 * int(max(it_k.max(), it_p.max())) * 2.0 ** -23
        d_k, d_p = np.abs(got - ref).max(), np.abs(plain - ref).max()
        assert np.isfinite(got).all()
        assert d_k <= chip_smoke.KERNEL_VS_PLAIN * d_p + floor * np.abs(
            ref).max(), (d_k, d_p)


@pytest.mark.gpu
def test_native_core_builds_and_solves_on_the_cards_machine():
    """The native C++ core built with this machine's g++ from the port's
    source into build/porqua_tpu_torch/, solving a tracking QP to the
    f64 IPM oracle's objective."""
    from porqua_tpu_torch import native
    from porqua_tpu_torch.compare import solution_metrics
    from porqua_tpu_torch.qp.ipm import solve_ipm

    need_card()
    path = native.build_library()
    assert "build/porqua_tpu_torch/libporqua_qp-" in path
    Xs, ys = pt.synthetic_universe_np(3, 1, 60, 20)
    X, y = Xs[0].astype(np.float64), ys[0].astype(np.float64)
    parts = dict(P=2.0 * X.T @ X, q=-2.0 * X.T @ y, C=np.ones((1, 20)),
                 l=np.ones(1), u=np.ones(1), lb=np.zeros(20),
                 ub=np.full(20, 0.2), constant=float(y @ y))
    sol = native.solve_qp_native(*(parts[k] for k in ("P", "q", "C", "l",
                                                      "u", "lb", "ub")))
    ipm = solve_ipm(parts)
    assert sol.status == 1 and ipm.found
    f = solution_metrics(parts, sol.x)["objective_value"]
    f_ipm = solution_metrics(parts, ipm.x)["objective_value"]
    assert abs(f - f_ipm) <= 1e-6 * max(1.0, abs(f_ipm))


@pytest.mark.gpu
def test_transfer_guard_on_the_card(monkeypatch):
    """The transfer guard on cuda:0: a hidden read, a copy from the host
    and an operand on the host raise; a declared read passes; a guarded
    solve answers the unguarded bits through its kernel."""
    from porqua_tpu_torch.analysis import sanitize

    need_card()
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    x = torch.ones(3, device="cuda")
    host = torch.ones(3)
    for fn in (lambda: x.sum().item(), lambda: host.to("cuda"),
               lambda: x + host, lambda: x.cpu()):
        with pytest.raises(sanitize.SanitizerError):
            with sanitize.transfer_guard():
                fn()
    with sanitize.transfer_guard():
        with sanitize.explicit_transfer():
            assert bool((x + 1.0).all())
    Xs, ys = pt.synthetic_universe_np(3, 8, 40, 16)
    qp = pt.build_tracking_qp(torch.as_tensor(Xs, device="cuda"),
                              torch.as_tensor(ys, device="cuda"))
    params = pt.SolverParams(backend="pallas", linsolve="trinv")
    monkeypatch.setenv("PORQUA_SANITIZE", "0")
    plain = pt.solve_qp_batch(qp, params)
    monkeypatch.setenv("PORQUA_SANITIZE", "1")
    with sanitize.transfer_guard():
        guarded = pt.solve_qp_batch(qp, params)
    assert all(torch.equal(a, b) for a, b in zip(guarded, plain)
               if a is not None)


@pytest.mark.gpu
def test_sharded_solve_on_cuda0():
    """solve_qp_sharded over make_mesh() on the card equals the unsharded
    solve bit for bit, results on the mesh's first device."""
    from porqua_tpu_torch.parallel import make_mesh, solve_qp_sharded

    need_card()
    Xs, ys = pt.synthetic_universe_np(4, 12, 40, 16)
    qp = pt.build_tracking_qp(torch.as_tensor(Xs, device="cuda"),
                              torch.as_tensor(ys, device="cuda"))
    params = pt.SolverParams(backend="pallas", linsolve="woodbury")
    mesh = make_mesh()
    assert mesh.devices.flat[0] == torch.device("cuda", 0)
    sharded = solve_qp_sharded(qp, mesh, params)
    plain = pt.solve_qp_batch(qp, params)
    assert sharded.x.device == torch.device("cuda", 0)
    if mesh.size == 1:
        assert all(torch.equal(a, b) for a, b in zip(sharded, plain)
                   if a is not None)
    else:
        torch.testing.assert_close(sharded.x, plain.x, rtol=0, atol=1e-5)
