#!/usr/bin/env python
"""Benchmark: BGV ciphertext multiply + relinearization throughput per GPU.

North-star config (BASELINE.json configs[3]-[4]): ring with 2^15
coefficients (m' = 2^16), 8 RNS limbs (~30-bit NTT primes), CRT-gadget
relinearization with Shoup hints, a batch of distinct ciphertexts — the
fused jitted fast path (she/fast.py) in its default formulation
(fast.DEFAULT_IMPL). Exits non-zero when JAX finds no GPU.

Prints ONE JSON line: {"metric", "value", "unit", ...} with the device
(platform, device_kind, count) and the card's name and power limit. Details
go to stderr.

Env: BENCH_LOG_N (15), BENCH_NLIMB (8), BENCH_SECONDS (2.0), BENCH_BATCH
(16), BENCH_CHAIN (1), BENCH_KS (trivgad | hybrid), BENCH_IMPL (one of
fast.IMPLS; default fast.DEFAULT_IMPL), BENCH_SWEEP (1: also 2^14, 2^16),
BENCH_HYBRID_SHOUP (1: Shoup hints for hybrid).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(x):
    return x.block_until_ready()


def _timed_loop(step, state, min_seconds: float = 1.0, windows: int = 5):
    """Run `state = step(state)` until the measured span exceeds min_seconds
    (doubling the iteration count), each span ending in block_until_ready.
    The final count is re-measured over `windows` spans; the headline is
    the best window, with median and IQR over the windows beside it."""
    iters = 4
    while True:
        t0 = time.perf_counter()
        s = state
        for _ in range(iters):
            s = step(s)
        _sync(s)
        dt = time.perf_counter() - t0
        if dt >= min_seconds or iters >= 1 << 20:
            break
        iters *= 2
    spans = [dt]
    for _ in range(max(0, windows - 1)):
        t0 = time.perf_counter()
        for _ in range(iters):
            s = step(s)
        _sync(s)
        spans.append(time.perf_counter() - t0)
    per = np.sort(np.asarray(spans) / iters)
    stats = {
        "best": float(per[0]),
        "median": float(np.median(per)),
        "iqr": float(np.percentile(per, 75) - np.percentile(per, 25)),
        "windows": len(per),
    }
    best = float(per[0])
    return 1.0 / best, best, stats


def bench_on(device, p, rng, min_seconds=1.0, batch: int = 1, chain: int = 1,
             ks: str = "trivgad"):
    """Throughput of ct mult+relin over `batch` distinct ciphertexts.
    `chain` fuses that many dependent mul_relin ops into ONE jitted XLA
    program — the deep-circuit shape (BASELINE.json configs[3] is a
    depth-16 mul chain). ks="hybrid" uses hybrid key-switching
    (she/hybrid.py — dnum digit groups + special modulus; pays off at deep
    chains, BENCH_NLIMB >= 12)."""
    import jax
    import jax.numpy as jnp
    from functools import partial
    from alchemy_tpu.she import fast

    with jax.default_device(device):
        if ks == "hybrid":
            from alchemy_tpu.she.hybrid import (
                HybridKS, hybrid_keygen_hint, mul_relin_hybrid)

            hk = HybridKS.make(p)
            s, (hb, ha) = hybrid_keygen_hint(hk, rng)
            # raw hints by default: hybrid has 2·dnum·T hint products per op
            # (vs 2·L² for TrivGad), so Shoup companions double the hint
            # bytes for a smaller saving
            if os.environ.get("BENCH_HYBRID_SHOUP") == "1":
                hb = fast.shoup_precompute(hb, hk.pe.qs)
                ha = fast.shoup_precompute(ha, hk.pe.qs)
            mul_fn = lambda pp, a, b, h0, h1: mul_relin_hybrid(hk, a, b, h0, h1)
        else:
            s = fast.keygen(p, rng)
            hb, ha = fast.relin_hint(p, s, rng, shoup=True)
            mul_fn = fast.mul_relin

        def cts():
            return [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
                    for _ in range(batch)]

        ct1, ct2 = jnp.stack(cts()), jnp.stack(cts())
        if batch == 1:
            ct1, ct2 = ct1[0], ct2[0]

        @partial(jax.jit, static_argnums=0)
        def step(pp, a, o, b_h, a_h):
            for _ in range(chain):
                o = mul_fn(pp, a, o, b_h, a_h)
            return o

        out = step(p, ct1, ct2, hb, ha)  # compile + warm
        _sync(out)
        ops, per, stats = _timed_loop(
            lambda o: step(p, ct1, o, hb, ha), out, min_seconds
        )
        scale = batch * chain
        stats = {k: (v / scale if k != "windows" else v)
                 for k, v in stats.items()}
        return ops * scale, per / scale, stats


def bench_ntt(device, p, min_seconds=1.0, batch: int = 1):
    """Jitted NTT latency. batch>1 stacks independent transforms in ONE
    jitted call — per-transform time at queue depth `batch`, showing how
    much of the depth-1 figure is dispatch."""
    import jax
    import jax.numpy as jnp
    from alchemy_tpu.she.fast import _ntt_p

    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs]).astype(np.uint32)
    if batch > 1:
        x = np.stack([x] * batch)
    step = jax.jit(lambda v: _ntt_p(p, v))   # jitted step: honest latency
    with jax.default_device(device):
        xd = jnp.asarray(x)
        y = step(xd)
        _sync(y)
        ops, lat, _ = _timed_loop(step, y, min_seconds)
        return lat / batch


def main():
    import jax

    from alchemy_tpu.she.fast import FastParams
    from alchemy_tpu.utils.cache import setup_compile_cache
    from alchemy_tpu.utils.profiling import card_info

    devs = jax.devices()
    accel = devs[0]
    if accel.platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX devices: {devs})")
    setup_compile_cache()

    log_n = int(os.environ.get("BENCH_LOG_N", "15"))
    nlimb = int(os.environ.get("BENCH_NLIMB", "8"))
    secs = float(os.environ.get("BENCH_SECONDS", "2.0"))
    # batch 16: per-card throughput over a batch of distinct ciphertexts
    # (BASELINE.json configs[4] is a batched SIMD workload); the single-ct
    # latency is measured separately and recorded as latency_1ct_ms
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    # chain>1 fuses dependent ops into one XLA program; the headline stays
    # per-op
    chain = int(os.environ.get("BENCH_CHAIN", "1"))
    # "hybrid": dnum-grouped key-switching over a special modulus
    # (she/hybrid.py) — the right choice at deep chains (BENCH_NLIMB >= 12)
    ks = os.environ.get("BENCH_KS", "trivgad")
    try:
        p = FastParams.make(log_n, nlimb, zp=2,
                            impl=os.environ.get("BENCH_IMPL") or None)
    except ValueError as e:
        sys.exit(f"bench: BENCH_IMPL: {e}")
    card = card_info().splitlines()[0]
    log(f"device: {accel.device_kind} x{len(devs)} ({card}) | ring "
        f"n=2^{log_n}, limbs={nlimb}, impl={p.impl}")

    ops_accel, per_op, stats = bench_on(accel, p, np.random.default_rng(0),
                                        secs, batch=batch, chain=chain, ks=ks)
    log(f"mul_relin (batch={batch}, chain={chain}, ks={ks}): "
        f"{ops_accel:.2f} ops/s ({per_op*1e3:.3f} ms/op; median "
        f"{stats['median']*1e3:.3f} ms, IQR {stats['iqr']*1e3:.3f} ms over "
        f"{stats['windows']} windows)")

    lat_1ct = None
    if batch > 1:
        _, lat_1ct, _ = bench_on(accel, p, np.random.default_rng(0),
                                 min(secs, 1.5), batch=1, chain=chain, ks=ks)
        log(f"single-ct latency: {lat_1ct*1e3:.3f} ms")

    ntt_lat = bench_ntt(accel, p, secs)
    ntt_lat_b8 = bench_ntt(accel, p, min(secs, 2.0), batch=8)
    log(f"NTT (n=2^{log_n}, {nlimb} limbs) latency: {ntt_lat*1e6:.0f} us "
        f"(amortized at queue depth 8: {ntt_lat_b8*1e6:.0f} us)")

    # the north-star range is 2^14–2^16 (BASELINE.json): sweep the other
    # two ring sizes at the same limb count and ks, each in its own
    # formulation unless BENCH_IMPL fixes one (BENCH_SWEEP=0 to skip)
    sweep = {}
    if os.environ.get("BENCH_SWEEP", "1") != "0":
        for ln in (14, 15, 16):
            if ln == log_n:
                sweep[f"n2e{ln}"] = {
                    "mul_relin_ops_per_s": ops_accel,
                    "ms_median": stats["median"] * 1e3,
                    "ms_iqr": stats["iqr"] * 1e3,
                    "ntt_us": ntt_lat * 1e6,
                    "ntt_us_qd8": ntt_lat_b8 * 1e6,
                }
                continue
            ps = FastParams.make(ln, nlimb, zp=2,
                                 impl=os.environ.get("BENCH_IMPL") or None)
            o, _, st = bench_on(accel, ps, np.random.default_rng(0),
                                min(secs, 2.0), batch=batch, ks=ks)
            nl = bench_ntt(accel, ps, min(secs, 2.0))
            sweep[f"n2e{ln}"] = {
                "mul_relin_ops_per_s": o,
                "ms_median": st["median"] * 1e3,
                "ms_iqr": st["iqr"] * 1e3,
                "ntt_us": nl * 1e6,
                "impl": ps.impl,
            }
            log(f"sweep n=2^{ln}: {o:.2f} ops/s (median "
                f"{st['median']*1e3:.3f} ms), NTT {nl*1e6:.0f} us")

    rec = {
        "metric": f"bgv_mul_relin_ops_per_s_n2e{log_n}_L{nlimb}"
                  + ("_hybrid" if ks == "hybrid" else ""),
        "value": ops_accel,
        "unit": "ops/s",
        "device": {"platform": accel.platform, "kind": accel.device_kind,
                   "count": len(devs)},
        "card": card,
        "impl": p.impl,
        "batch": batch,
        "latency_1ct_ms": lat_1ct * 1e3 if lat_1ct else None,
        "dispersion": {
            "ms_best": stats["best"] * 1e3,
            "ms_median": stats["median"] * 1e3,
            "ms_iqr": stats["iqr"] * 1e3,
            "windows": stats["windows"],
        },
        "ntt_us_qd1": ntt_lat * 1e6,
        "ntt_us_qd8": ntt_lat_b8 * 1e6,
    }
    if sweep:
        rec["sweep"] = sweep
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
