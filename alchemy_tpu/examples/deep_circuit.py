"""Deep-circuit config (BASELINE.json configs[3]): depth-D multiply chain
with full relinearization and dynamic noise management (rescale one limb per
level) on a power-of-2 ring.

The workload is a squaring chain mod 2: over F_2, (Σ a_i x^i)² = Σ a_i x^{2i}
(Frobenius), so the expected plaintext after D levels is the coefficient
permutation j ↦ 2^D·j mod 2n (with negacyclic wrap, which vanishes mod 2) —
an O(n) exact host check at any depth.

Noise management: per level ℓ the ciphertext is multiplied with itself,
relinearized with the level-ℓ hint, and rescaled by one ~30-bit limb. The
steady-state absolute error is the rescale rounding term (~p·|s|₁/2), so a
depth-D chain needs D+2 limbs.
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np

from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams


def expected_square_chain_mod2(msg: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Coefficients of msg^(2^depth) in Z_2[x]/(x^n+1)."""
    cur = np.asarray(msg, dtype=np.int64) % 2
    for _ in range(depth):
        nxt = np.zeros(n, dtype=np.int64)
        idx = (2 * np.arange(n)) % (2 * n)
        for j in range(n):
            t = idx[j]
            if t < n:
                nxt[t] ^= cur[j]
            else:
                nxt[t - n] ^= cur[j]  # x^n = -1 ≡ 1 mod 2
        cur = nxt
    return cur


def save_state(path: str, *, log_n: int, depth: int, level: int, ct,
               s_int, msg, impl, ks: str) -> None:
    """Mid-chain recovery checkpoint (SURVEY §5 failure/recovery): the
    secret key coefficients, plaintext oracle input, current ciphertext and
    chain position. Per-level hint randomness is NOT saved — hints are
    regenerated per level and the resumed process reseeds from OS entropy
    (the checkpoint-RNG rule of she/serialize.py)."""
    np.savez(path, log_n=log_n, depth=depth, level=level,
             ct=np.asarray(ct), s_int=np.asarray(s_int),
             msg=np.asarray(msg), impl=str(impl or ""), ks=ks)


def compile_levels(p: FastParams, levels, ks: str) -> None:
    """Compile the hint, mul+relin and rescale programs of every level in
    `levels` before the chain runs, side by side in threads. Each level has
    its own limb count and so its own programs; compiling them together
    spreads the work over the host's cores, and the calls in the chain then
    find them compiled."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from alchemy_tpu.she import hybrid

    n = p.n
    jobs = []
    for level in levels:
        cur = FastParams(n=n, qs=p.qs[:len(p.qs) - level], zp=p.zp,
                         impl=p.impl)
        L = len(cur.qs)
        ct = jax.ShapeDtypeStruct((2, L, n), jnp.uint32)
        if ks == "hybrid":
            hk = hybrid.HybridKS.make(cur)
            T = len(hk.pe.qs)
            h = jax.ShapeDtypeStruct((len(hk.groups), T, n), jnp.uint32)
            s = jax.ShapeDtypeStruct((T, n), jnp.uint32)
            jobs.append(partial(hybrid._hybrid_hint_rows.lower, hk, s, h, h))
            jobs.append(partial(hybrid.mul_relin_hybrid.lower, hk, ct, ct, h, h))
        else:
            h = jax.ShapeDtypeStruct((L, L, n), jnp.uint32)
            s = jax.ShapeDtypeStruct((L, n), jnp.uint32)
            jobs.append(partial(fast._relin_hint_rows.lower, cur, s, h, h))
            jobs.append(partial(fast.mul_relin.lower, cur, ct, ct, (h, h),
                                (h, h)))
        jobs.append(partial(fast.rescale.lower, cur, ct, 1))
    with ThreadPoolExecutor() as ex:
        list(ex.map(lambda lower: lower().compile(), jobs))


def run(log_n: int = 9, depth: int = 16, seed: int = 0, verbose: bool = True,
        impl: str | None = None, ks: str = "trivgad",
        stop_at_level: int | None = None, state_path: str | None = None,
        resume: bool = False, timings: dict | None = None):
    """Returns (ok, levels) — decrypt-correct after `depth` mul+relin+rescale
    levels. ks="hybrid" relinearizes with dnum-grouped hybrid key-switching
    (she/hybrid.py) — the cheaper choice at this workload's deep chains.

    Recovery drill (VERDICT r4 missing #5): `stop_at_level`+`state_path`
    checkpoints mid-chain and returns (None, level) WITHOUT finishing;
    `resume=True` loads the state from `state_path` in a fresh process
    (reseeding encryption/hint randomness from OS entropy) and completes
    the remaining levels; the decrypt oracle then checks the FULL chain.

    Every level's programs are compiled up front (`compile_levels`).
    `timings`, when given, receives the seconds spent compiling
    ("compile_s"), generating the per-level hints ("hints_s") and
    evaluating the levels ("levels_s"), each ending in block_until_ready."""
    import jax
    import jax.numpy as jnp

    from alchemy_tpu.she.keys import gaussian_coeffs

    if resume:
        st = np.load(state_path, allow_pickle=False)
        log_n, depth = int(st["log_n"]), int(st["depth"])
        level0 = int(st["level"])
        impl = str(st["impl"]) or None
        ks = str(st["ks"])
        p = FastParams.make(log_n, depth + 2, zp=2, impl=impl)
        s_int = st["s_int"]
        msg = st["msg"]
        ct = jnp.asarray(st["ct"])
        rng = np.random.default_rng()   # OS entropy — never replay
        cur_p = FastParams(n=p.n, qs=p.qs[:len(p.qs) - level0], zp=p.zp,
                           impl=p.impl)
    else:
        p = FastParams.make(log_n, depth + 2, zp=2, impl=impl)
        if ks == "auto":
            # hybrid does fewer limb transforms from L ≳ 12 (she/hybrid.py)
            ks = "hybrid" if len(p.qs) >= 12 else "trivgad"
        rng = np.random.default_rng(seed)
        s_int = gaussian_coeffs(rng, 1.0, p.n)
        level0 = 0

    def key_at(pp):
        res = np.stack([s_int % q for q in pp.qs]).astype(np.uint32)
        return fast._ntt_p(pp, jnp.asarray(res))

    if not resume:
        s = key_at(p)
        msg = rng.integers(0, 2, p.n)
        ct = fast.encrypt(p, s, msg, rng)
        cur_p = p

    t0 = time.perf_counter()
    stop = depth if stop_at_level is None else min(depth, stop_at_level)
    compile_levels(p, range(level0, stop), ks)
    if timings is not None:
        timings["compile_s"] = (timings.get("compile_s", 0.0)
                                + time.perf_counter() - t0)

    for level in range(level0, depth):
        if stop_at_level is not None and level == stop_at_level:
            save_state(state_path, log_n=log_n, depth=depth, level=level,
                       ct=ct, s_int=s_int, msg=msg, impl=impl, ks=ks)
            if verbose:
                print(f"checkpointed at level {level} -> {state_path}")
            return None, level
        t0 = time.perf_counter()
        if ks == "hybrid":
            from alchemy_tpu.she.hybrid import (
                HybridKS, hybrid_relin_hint, mul_relin_hybrid)

            hk = HybridKS.make(cur_p)
            hints = hybrid_relin_hint(hk, s_int, rng)
        else:
            hints = fast.relin_hint(cur_p, key_at(cur_p), rng, shoup=True)
        jax.block_until_ready(hints)
        t1 = time.perf_counter()
        if ks == "hybrid":
            ct = mul_relin_hybrid(hk, ct, ct, *hints)
        else:
            ct = fast.mul_relin(cur_p, ct, ct, *hints)
        ct = jax.block_until_ready(fast.rescale(cur_p, ct, 1))
        if timings is not None:
            timings["hints_s"] = timings.get("hints_s", 0.0) + t1 - t0
            timings["levels_s"] = (timings.get("levels_s", 0.0)
                                   + time.perf_counter() - t1)
        cur_p = FastParams(n=cur_p.n, qs=cur_p.qs[:-1], zp=cur_p.zp, impl=cur_p.impl)
        if verbose:
            print(f"level {level + 1}: limbs={len(cur_p.qs)}")

    dec = fast.decrypt(cur_p, key_at(cur_p), ct)
    want = expected_square_chain_mod2(msg, p.n, depth)
    ok = bool(np.array_equal(dec, want))
    if verbose:
        print("PASS" if ok else "FAIL")
    return ok, depth


if __name__ == "__main__":
    import os
    import sys

    from alchemy_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    ok, _ = run(
        log_n=int(os.environ.get("DEEP_LOG_N", "13")),
        depth=int(os.environ.get("DEEP_DEPTH", "16")),
        ks=os.environ.get("DEEP_KS", "trivgad"),
        impl=os.environ.get("DEEP_IMPL") or None,
    )
    sys.exit(0 if ok else 1)
