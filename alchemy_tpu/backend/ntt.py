"""Negacyclic NTT for power-of-2 rings — the jittable fast path.

Radix-2 DIF forward (natural → bit-reversed) and DIT inverse (bit-reversed →
natural) with the negacyclic ψ-twist folded into pre/post scaling vectors.
All twiddle multiplications are Shoup constant-multiplies (backend/xla.py);
stages are reshape + modadd/sub + lane multiply — fully vectorized, no
gathers, identical shapes for every limb (twiddles stacked per limb).

This is the kernel the benchmark ring (φ(m') = 2^15) runs on; the general
tensor-ring path (core/ring.py matrices) covers composite indices. Slot
order here is the transform's natural bit-reversed order: pointwise ct ops
are order-agnostic, and this path is used where no subring structure is
needed (DESIGN.md).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from alchemy_tpu.backend.xla import _cond_sub, mulmod_shoup, shoup_const
from alchemy_tpu.nt.primes import root_of_unity


@lru_cache(maxsize=None)
def _limb_tables(n: int, q: int):
    """One limb's tables (host numpy uint32): per stage s, the twiddles
    w^(j·2^s), their inverses and both Shoup companions; the pre-twist ψ^j
    and post-twist ψ^(-j)·n^(-1) with companions. Cached per limb, so the
    chains of a deep circuit, which share their limbs, build each once."""
    k = n.bit_length() - 1
    psi = root_of_unity(2 * n, q)
    w = psi * psi % q
    psi_inv = pow(psi, -1, q)
    n_inv = pow(n, -1, q)

    def with_shoup(vals):
        return (np.array(vals, dtype=np.uint32),
                np.array([(int(x) << 32) // q for x in vals], dtype=np.uint32))

    fwd, inv = [], []
    for s in range(k):
        m = n >> (s + 1)
        step = pow(w, 1 << s, q)
        tw = np.empty(m, dtype=np.int64)
        x = 1
        for j in range(m):
            tw[j] = x
            x = x * step % q
        fwd.append(with_shoup(tw))
        inv.append(with_shoup([pow(int(t), -1, q) for t in tw]))
    pre = with_shoup([pow(psi, j, q) for j in range(n)])
    post = with_shoup([pow(psi_inv, j, q) * n_inv % q for j in range(n)])
    return fwd, inv, pre, post


@lru_cache(maxsize=None)
def ntt_tables(n: int, qs: tuple[int, ...]):
    """Per-(ring size, chain) twiddle tables, stacked over the limbs.

    Returns dict with, per stage s (m = n >> (s+1)):
      fwd[s]:  [L, m] twiddles w^(j·2^s) and Shoup companions
      inv[s]:  [L, m] inverse twiddles
    plus pre-twist ψ^j and post-twist ψ^(-j)·n^(-1) vectors [L, n].
    Host numpy constants: safe to cache across jit traces (they embed as
    compile-time constants; device arrays here would leak tracers).
    """
    assert n & (n - 1) == 0, "fast NTT path requires power-of-2 size"
    k = n.bit_length() - 1
    limbs = [_limb_tables(n, q) for q in qs]

    def stack(pick):
        return tuple(np.stack([pick(t)[i] for t in limbs]) for i in (0, 1))

    return {
        "q": np.array(qs, dtype=np.uint32)[:, None],
        "fwd": [stack(lambda t, s=s: t[0][s]) for s in range(k)],
        "inv": [stack(lambda t, s=s: t[1][s]) for s in range(k)],
        "pre": stack(lambda t: t[2]),
        "post": stack(lambda t: t[3]),
    }


def _add_m(a, b, q):
    return _cond_sub(a + b, q)


def _sub_m(a, b, q):
    return jnp.where(a >= b, a - b, a + q - b)


def cyclic_ntt_stages(x, stages, q):
    """Radix-2 DIF cyclic NTT over the LAST axis (natural in → bit-reversed
    out). `stages[s]` = (W, WS) twiddles shaped [L?, m] broadcastable against
    the [..., L, n] input; `q` shaped like [L, 1]. Used standalone by the
    distributed 4-step NTT (parallel/dist.py)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    k = n.bit_length() - 1
    for s in range(k):
        m = n >> (s + 1)
        blocks = 1 << s
        xs = x.reshape(*lead, blocks, 2, m)
        a = xs[..., 0, :]
        b = xs[..., 1, :]
        W, WS = stages[s]
        top = _add_m(a, b, q[..., None, :])
        bot = mulmod_shoup(
            _sub_m(a, b, q[..., None, :]), W[..., None, :], WS[..., None, :], q[..., None, :]
        )
        x = jnp.stack([top, bot], axis=-2).reshape(*lead, n)
    return x


def cyclic_intt_stages(x, inv_stages, q, n_inv=None):
    """Inverse of `cyclic_ntt_stages` (bit-reversed in → natural out).
    If n_inv (w, ws) per limb is given, folds in the 1/n scaling."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    k = n.bit_length() - 1
    for s in reversed(range(k)):
        m = n >> (s + 1)
        blocks = 1 << s
        xs = x.reshape(*lead, blocks, 2, m)
        A = xs[..., 0, :]
        B = xs[..., 1, :]
        W, WS = inv_stages[s]
        bw = mulmod_shoup(B, W[..., None, :], WS[..., None, :], q[..., None, :])
        a = _add_m(A, bw, q[..., None, :])
        b = _sub_m(A, bw, q[..., None, :])
        x = jnp.stack([a, b], axis=-2).reshape(*lead, n)
    if n_inv is not None:
        w, ws = n_inv
        x = mulmod_shoup(x, w, ws, q)
    return x


@partial(jax.jit, static_argnums=(1, 2))
def ntt_negacyclic(x, n: int, qs: tuple[int, ...]):
    """Forward negacyclic NTT on [..., L, n] (natural in, bit-reversed out)."""
    t = ntt_tables(n, qs)
    q = t["q"]
    pre, pre_s = t["pre"]
    x = mulmod_shoup(x, pre, pre_s, q)
    lead = x.shape[:-2]
    L = x.shape[-2]
    k = n.bit_length() - 1
    for s in range(k):
        m = n >> (s + 1)
        blocks = 1 << s
        xs = x.reshape(*lead, L, blocks, 2, m)
        a = xs[..., 0, :]
        b = xs[..., 1, :]
        W, WS = t["fwd"][s]
        q4 = q[:, None, :]
        top = _add_m(a, b, q4)
        bot = mulmod_shoup(_sub_m(a, b, q4), W[:, None, :], WS[:, None, :], q4)
        x = jnp.stack([top, bot], axis=-2).reshape(*lead, L, n)
    return x


@partial(jax.jit, static_argnums=(1, 2))
def intt_negacyclic(x, n: int, qs: tuple[int, ...]):
    """Inverse negacyclic NTT on [..., L, n] (bit-reversed in, natural out)."""
    t = ntt_tables(n, qs)
    q = t["q"]
    lead = x.shape[:-2]
    L = x.shape[-2]
    k = n.bit_length() - 1
    for s in reversed(range(k)):
        m = n >> (s + 1)
        blocks = 1 << s
        xs = x.reshape(*lead, L, blocks, 2, m)
        A = xs[..., 0, :]
        B = xs[..., 1, :]
        W, WS = t["inv"][s]
        q4 = q[:, None, :]
        bw = mulmod_shoup(B, W[:, None, :], WS[:, None, :], q4)
        a = _add_m(A, bw, q4)
        b = _sub_m(A, bw, q4)
        x = jnp.stack([a, b], axis=-2).reshape(*lead, L, n)
    post, post_s = t["post"]
    return mulmod_shoup(x, post, post_s, q)
