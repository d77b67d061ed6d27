"""Break down mul_relin time on the accelerator by timing stage-ablated
variants of the fused op (everything passed as arguments, so no device array
is baked into the program as a constant).

Run from the repo root: python scripts/profile_mul_relin.py
Env: PROF_LOG_N (default 15), PROF_NLIMB (default 8), PROF_SECONDS.
"""
from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams, _ntt_p, _intt_p, _add
from alchemy_tpu.backend.xla import mulmod
from alchemy_tpu.utils.cache import setup_compile_cache


def sync(x):
    return x.block_until_ready()


def timed_loop(step, state, min_seconds=1.0):
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


@partial(jax.jit, static_argnums=0)
def upto_tensor(p, ct_a, ct_b, hint_b, hint_a):
    """Just the 4 ct-tensor mulmods (c0, c1, c2)."""
    qs = p.qs
    a0, a1 = ct_a[..., 0, :, :], ct_a[..., 1, :, :]
    b0, b1 = ct_b[..., 0, :, :], ct_b[..., 1, :, :]
    c0 = mulmod(a0, b0, qs)
    c1 = _add(mulmod(a0, b1, qs), mulmod(a1, b0, qs), p)
    c2 = mulmod(a1, b1, qs)
    return jnp.stack([c0, _add(c1, c2, p)], axis=-3)


@partial(jax.jit, static_argnums=0)
def upto_intt(p, ct_a, ct_b, hint_b, hint_a):
    """Tensor mulmods + the inverse NTT of c2."""
    qs = p.qs
    a0, a1 = ct_a[..., 0, :, :], ct_a[..., 1, :, :]
    b0, b1 = ct_b[..., 0, :, :], ct_b[..., 1, :, :]
    c0 = mulmod(a0, b0, qs)
    c1 = _add(mulmod(a0, b1, qs), mulmod(a1, b0, qs), p)
    c2 = mulmod(a1, b1, qs)
    cc = _intt_p(p, c2)
    return jnp.stack([c0, _add(c1, _ntt_onelimb_like(p, cc), p)], axis=-3)


def _ntt_onelimb_like(p, cc):
    # cheap folding so XLA can't drop the intt: reuse coefficients as residues
    return cc


@partial(jax.jit, static_argnums=0)
def upto_digits(p, ct_a, ct_b, hint_b, hint_a):
    """Tensor mulmods + intt + the [L, L, n] digit forward NTT (no hint mults)."""
    qs = p.qs
    L = len(qs)
    a0, a1 = ct_a[..., 0, :, :], ct_a[..., 1, :, :]
    b0, b1 = ct_b[..., 0, :, :], ct_b[..., 1, :, :]
    c0 = mulmod(a0, b0, qs)
    c1 = _add(mulmod(a0, b1, qs), mulmod(a1, b0, qs), p)
    c2 = mulmod(a1, b1, qs)
    c2_coeff = _intt_p(p, c2)
    rows = c2_coeff[..., :, None, :]
    bc = jnp.broadcast_to(rows, (*c2_coeff.shape[:-2], L, L, p.n))
    dig_ntt = _ntt_p(p, bc)
    fold = dig_ntt.sum(axis=-3) % jnp.uint32(1 << 30)  # cheap fold, keeps all digits live
    return jnp.stack([c0, _add(c1, fold & jnp.uint32((1 << 28) - 1), p)], axis=-3)


def main():
    log_n = int(os.environ.get("PROF_LOG_N", "15"))
    L = int(os.environ.get("PROF_NLIMB", "8"))
    secs = float(os.environ.get("PROF_SECONDS", "1.5"))
    setup_compile_cache()
    p = FastParams.make(log_n, L, zp=2)
    rng = np.random.default_rng(0)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    ct1 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    ct2 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)

    for name, fn in [
        ("tensor-muls only", upto_tensor),
        ("+ intt(c2)", upto_intt),
        ("+ digit NTT [L,L,n]", upto_digits),
        ("full mul_relin", fast.mul_relin),
    ]:
        out = fn(p, ct1, ct2, hb, ha)
        sync(out)
        t = timed_loop(lambda o, f=fn: f(p, ct1, o, hb, ha), out, secs)
        print(f"{name:24s} {t*1e6:9.1f} us/op", flush=True)


if __name__ == "__main__":
    main()
