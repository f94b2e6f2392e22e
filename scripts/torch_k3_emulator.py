#!/usr/bin/env python3
"""Replay the explicit-inverse cluster kernel's f32 arithmetic on the CPU.

    PYTHONPATH=. python3 scripts/torch_k3_emulator.py [--n 10] [--m 1]
        [--orders 40]

``csrc/admm_segment_dense_cluster.cu`` (``dense_cluster_kernel<false,
16>``) runs a segment of ADMM iterations with ``xt = rhs @ K^-1``. This
script repeats its arithmetic in numpy, operation for operation and in
its summation order, on the inputs of the ``gpu`` test
``test_cuda_kernel_matches_plain_twin[inverse]`` (tests/test_torch_cuda.py),
and prints each output's distance to the plain twin run in float64,
beside the twin rule's floor. It replays:

- ``m-row``: the m-row update (C xt summed per rank, then in rank
  order; z-clip and dual step) in f32, as the kernel, the twin and the
  TPU kernel do it, or in f64 (``m-row f64``);
- the product ``rhs @ K^-1`` in the kernel's order (a lane per row of
  the rank's slice, a shuffle tree over the lanes that share a column
  group, then the warps' partials in warp order), or accumulated
  exactly and rounded once (``product f64``), or summed over the rows
  in ``--orders`` random orders (the spread of f32 rounding noise that
  the twin's own distance is one draw of).

An FMA is modelled as the exact product plus the addend, rounded once
to f32; ``a * b + c`` in the kernel's source is taken to be contracted
to ``fmaf(a, b, c)``, as nvcc does by default. On that case the
replay matches the card to four digits (H100 80GB HBM3, 700 W): mu
2.168e-8 for the kernel as it is, and 5.175e-8 for a version of it
that made the m-row update in f64.
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Import the test module by path: an installed distribution may ship a
# regular ``tests`` package that shadows this repo's namespace one.
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_cuda as tc  # noqa: E402

F32 = np.float32
RANKS, THREADS = 16, 256
WARPS = THREADS // 32
NAMES = ("x", "z", "w", "y", "mu", "dx", "dy", "dmu")


def fma(a, b, c):
    """fmaf: the exact product plus c, rounded once to f32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def lanes_per_row(q4):
    g = 1
    while g < q4 and g < 32:
        g <<= 1
    return g


def product_kernel_order(rhs, K):
    """rhs @ K in the kernel's order, rank by rank over its columns."""
    n = K.shape[0]
    nc = -(-n // RANKS)
    ld = (nc + 3) // 4 * 4
    g = lanes_per_row(ld // 4)
    per_warp = 32 // g
    step = WARPS * per_warp
    xt = np.zeros(n, F32)
    for rank in range(RANKS):
        first = min(n, rank * nc)
        cols = min(n, first + nc) - first
        for c in range(cols):
            j = first + c
            parts = []
            for warp in range(WARPS):
                lane_acc = np.zeros(32, F32)
                for lane in range(32):
                    sub, cq = lane // g, lane % g
                    if cq != c // 4 % g:  # the lane holding this column
                        continue
                    acc = F32(0)
                    for i in range(warp * per_warp + sub, n, step):
                        acc = fma(rhs[i], K[i, j], acc)
                    lane_acc[lane] = acc
                o = g
                while o < 32:   # shuffle xor tree over the lane groups
                    lane_acc = (lane_acc + lane_acc[np.arange(32) ^ o]
                                ).astype(F32)
                    o <<= 1
                parts.append(lane_acc[(c // 4) % g])
            total = parts[0]
            for p in parts[1:]:
                total = F32(total + p)
            xt[j] = total
    return xt


def product_exact(rhs, K):
    return (rhs.astype(np.float64) @ K.astype(np.float64)).astype(F32)


def product_in_order(rhs, K, rng):
    """Each column summed serially over the rows in a random order."""
    n = K.shape[0]
    xt = np.zeros(n, F32)
    for j in range(n):
        acc = F32(0)
        for i in rng.permutation(n):
            acc = fma(rhs[i], K[i, j], acc)
        xt[j] = acc
    return xt


def c_xt(C, xt, f64):
    """(C xt)[r]: each rank's warp sums its columns (lane-strided, a
    shuffle tree), then the ranks' partials in rank order."""
    m, n = C.shape
    nc = -(-n // RANKS)
    dt = np.float64 if f64 else F32
    out = np.zeros(m, dt)
    for r in range(m):
        total = dt(0)
        for rank in range(RANKS):
            first = min(n, rank * nc)
            cols = min(n, first + nc) - first
            lanes = np.zeros(32, dt)
            for lane in range(32):
                acc = dt(0)
                for c in range(lane, cols, 32):
                    if f64:
                        acc += np.float64(C[r, first + c]) * xt[first + c]
                    else:
                        acc = fma(C[r, first + c], xt[first + c], acc)
                lanes[lane] = acc
            o = 16
            while o > 0:
                lanes = (lanes + lanes[np.arange(32) ^ o]).astype(dt)
                o >>= 1
            total = dt(total + lanes[0]) if rank else lanes[0]
        out[r] = total
    return out


def segment(args, kw, product, row_f64):
    (K, C, q, l, u, lb, ub, rho, rho_b, l1w, l1c, x, z, w, y,
     mu) = [a.numpy().astype(F32) for a in args]
    sig, al = F32(kw["sigma"]), F32(kw["alpha"])
    om = F32(1.0 - kw["alpha"])
    outs = []
    for b in range(x.shape[0]):
        xb, zb, wb, yb, mub = (x[b].copy(), z[b].copy(), w[b].copy(),
                               y[b].copy(), mu[b].copy())
        for it in range(kw["n_iters"]):
            if it == kw["n_iters"] - 1:
                xp, yp, mup = xb.copy(), yb.copy(), mub.copy()
            tm = fma(rho[b], zb, -yb)
            ct = np.zeros_like(xb)
            for r in range(len(zb)):
                ct = fma(tm[r], C[b, r], ct)
            rhs = (fma(sig, xb, -q[b]) + ct).astype(F32)
            rhs = (rhs + fma(rho_b[b], wb, -mub)).astype(F32)
            xt = product(rhs, K[b])
            zt = c_xt(C[b], xt, row_f64)
            inv_rhob = (F32(1) / rho_b[b]).astype(F32)
            xn = fma(al, xt, (om * xb).astype(F32))
            wpre = fma(al, xt, (om * wb).astype(F32))
            s = (fma(mub, inv_rhob, wpre) - l1c[b]).astype(F32)
            t = (l1w[b] * inv_rhob).astype(F32)
            soft = (np.sign(s) * np.maximum(np.abs(s) - t, 0)).astype(F32)
            wn = np.clip((l1c[b] + soft).astype(F32), lb[b], ub[b])
            mun = fma(rho_b[b], (wpre - wn).astype(F32), mub)
            inv_rho = (F32(1) / rho[b]).astype(F32)
            if row_f64:
                zp = np.float64(al) * zt + np.float64(om) * zb
                zn = np.minimum(np.maximum(zp + yb.astype(np.float64)
                                           * inv_rho, l[b]), u[b])
                yn = (yb + rho[b].astype(np.float64) * (zp - zn)).astype(F32)
                zn = zn.astype(F32)
            else:
                zp = fma(al, zt, (om * zb).astype(F32))
                zn = np.clip(fma(yb, inv_rho, zp), l[b], u[b])
                yn = fma(rho[b], (zp - zn).astype(F32), yb)
            xb, zb, wb, yb, mub = xn, zn, wn, yn, mun
        outs.append((xb, zb, wb, yb, mub, (xb - xp).astype(F32),
                     (yb - yp).astype(F32), (mub - mup).astype(F32)))
    return [torch.as_tensor(np.stack([o[i] for o in outs]))
            for i in range(8)]


def distances(out, exact):
    return [float((a.double() - e).abs().max()) for a, e in zip(out, exact)]


def line(label, values):
    return f"{label:28s} " + " ".join(f"{v:9.3e}" for v in values)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--orders", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()
    fn, args, kw = tc.kernel_inputs("inverse", np.float32, n=opts.n,
                                    m=opts.m)
    exact = tc.TWIN[fn](*(a.double() for a in args), **kw)
    scale = [float(exact[tc.SCALE_OF[i]].abs().max()) for i in range(8)]
    print(f"inverse segment, n={opts.n} m={opts.m} "
          f"n_iters={kw['n_iters']}; distance to the f64 twin per output")
    print(f"{'':28s} " + " ".join(f"{n:>9s}" for n in NAMES))
    print(line("floor (2 ulps x scale/iter)",
               [tc.f32_floor(kw) * s for s in scale]))
    print(line("f32 twin, CPU", distances(tc.TWIN[fn](*args, **kw), exact)))
    for row_f64 in (False, True):
        row = "m-row f64" if row_f64 else "m-row f32"
        print(line(f"kernel order, {row}",
                   distances(segment(args, kw, product_kernel_order,
                                     row_f64), exact)))
        print(line(f"product f64, {row}",
                   distances(segment(args, kw, product_exact, row_f64),
                             exact)))
        rng = np.random.default_rng(opts.seed)
        spread = np.array([distances(segment(
            args, kw, lambda r, K: product_in_order(r, K, rng), row_f64),
            exact) for _ in range(opts.orders)])
        for stat, f in (("min", np.min), ("median", np.median),
                        ("max", np.max)):
            print(line(f"{opts.orders} orders {stat}, {row}",
                       f(spread, axis=0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
