#!/usr/bin/env python
"""Deep-config comparison: TrivGad vs hybrid key-switching (she/hybrid.py).

Measures BGV ct mult+relin at a deep chain (default L=16, n=2^15) in the
default formulation (fast.DEFAULT_IMPL) for both gadgets, checking
decrypt parity. Run from the repo root: python scripts/bench_hybrid.py
Knobs: HB_LOG_N, HB_NLIMB, HB_SECONDS.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from alchemy_tpu.utils.cache import setup_compile_cache

setup_compile_cache()

from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams
from alchemy_tpu.she.hybrid import HybridKS, hybrid_keygen_hint, mul_relin_hybrid


def sync(x):
    return x.block_until_ready()


def timed(step, state, min_seconds):
    """Time-doubling steady-state loop (a handful of iterations is
    dispatch-latency-dominated)."""
    sync(state)
    iters = 4
    while True:
        t0 = time.perf_counter()
        s = state
        for _ in range(iters):
            s = step(s)
        sync(s)
        dt = time.perf_counter() - t0
        if dt >= min_seconds or iters >= 1 << 20:
            return dt / iters
        iters *= 2


def main():
    log_n = int(os.environ.get("HB_LOG_N", "15"))
    nlimb = int(os.environ.get("HB_NLIMB", "16"))
    secs = float(os.environ.get("HB_SECONDS", "2.0"))
    p = FastParams.make(log_n, nlimb, zp=2)
    hk = HybridKS.make(p)
    print(f"n=2^{log_n}, L={nlimb}, groups={[len(g) for g in hk.groups]}, "
          f"K={len(hk.ps)}, impl={p.impl} | {jax.devices()[0].device_kind}")
    rng = np.random.default_rng(1)
    s, (hb, ha) = hybrid_keygen_hint(hk, rng)
    tb, ta = fast.relin_hint(p, s, np.random.default_rng(2), shoup=True)
    c1 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    c2 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    from functools import partial

    @partial(jax.jit, static_argnums=0)
    def step_h(hk_, o):
        return mul_relin_hybrid(hk_, c1, o, hb, ha)

    @partial(jax.jit, static_argnums=0)
    def step_t(p_, o):
        return fast.mul_relin(p_, c1, o, tb, ta)

    o_h = step_h(hk, c2)
    o_t = step_t(p, c2)
    d_h = timed(lambda o: step_h(hk, o), o_h, secs)
    d_t = timed(lambda o: step_t(p, o), o_t, secs)
    print(f"hybrid  {d_h*1e3:8.2f} ms/op ({1/d_h:7.1f} ops/s)")
    print(f"trivgad {d_t*1e3:8.2f} ms/op ({1/d_t:7.1f} ops/s)  -> {d_t/d_h:.2f}x")
    print("decrypt parity:",
          np.array_equal(fast.decrypt(p, s, o_h), fast.decrypt(p, s, o_t)))


if __name__ == "__main__":
    main()
