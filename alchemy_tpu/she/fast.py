"""Fused, jittable BGV ops on raw arrays — the accelerator hot path.

Operates on power-of-2 rings (backend/ntt.py) with ciphertexts as
`uint32[ncomp, L, n]` in the NTT (evaluation) domain. This is the flagship
compute step for the benchmark configs (BASELINE.json configs[3]-[4]): fused
ciphertext multiply + gadget re-linearization + rescale, compiled as one XLA
program (`jax.jit`), batchable over leading axes, shardable with shard_map
(parallel/).

The CRT-gadget digit decomposition needs one inverse NTT (to coefficients)
and L forward NTTs (one per digit) — the standard RNS relinearization
dataflow. Digits are single-limb residues reduced into every limb exactly
(DESIGN.md RNS discipline; matches she/gadget.py TrivGad).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.backend.ntt_mxu import intt_mxu, ntt_mxu, ntt_mxu_bcast
from alchemy_tpu.backend.ntt_mxu3 import intt_mxu3, ntt_mxu3, ntt_mxu3_bcast
from alchemy_tpu.backend.xla import (
    _cond_sub,
    _split,
    mulmod,
    mulmod_shoup,
    shoup_const,
)
from alchemy_tpu.nt.primes import find_ntt_prime
from alchemy_tpu.she.keys import gaussian_coeffs, uniform_residues

#: the exact NTT formulations of the fast path: "vpu" (radix-2 butterflies,
#: backend/ntt.py), "mxu"/"mxu8" (2-factor digit-plane matmuls in bf16 or
#: int8, backend/ntt_mxu.py) and "mxu3" (3-factor 128·128·r digit-plane
#: matmuls, backend/ntt_mxu3.py). Slot orders differ but are internally
#: consistent, so all fused ops and decrypt agree within one FastParams, and
#: coefficient-domain results are bit-identical across formulations.
IMPLS = ("vpu", "mxu", "mxu8", "mxu3")

#: the formulation when none is given, on every platform and ring size: the
#: butterflies were the fastest mul+relin on the H100 at 2^14 and 2^16 (L=8,
#: batch 16) and compile without GEMM autotuning
DEFAULT_IMPL = "vpu"


@dataclass(frozen=True)
class FastParams:
    """Static configuration of the fast path."""

    n: int                    # φ(m') — power of two
    qs: tuple[int, ...]       # RNS chain (all ≡ 1 mod 2n)
    zp: int = 2               # plaintext modulus
    impl: str | None = None   # one of IMPLS; None: DEFAULT_IMPL

    def __post_init__(self):
        if self.impl is None:
            object.__setattr__(self, "impl", DEFAULT_IMPL)
        elif self.impl not in IMPLS:
            raise ValueError(f"unknown fast-path formulation {self.impl!r}; "
                             f"expected one of {IMPLS}")

    @staticmethod
    def make(log_n: int, nlimb: int, zp: int = 2, bits: int = 30,
             impl: str | None = None) -> "FastParams":
        n = 1 << log_n

        qs: list[int] = []
        while len(qs) < nlimb:
            qs.append(find_ntt_prime(2 * n, bits, avoid=tuple(qs)))
        return FastParams(n=n, qs=tuple(qs), zp=zp, impl=impl)


def _ntt_p(p, x):
    if p.impl == "vpu":
        return ntt_negacyclic(x, p.n, p.qs)
    if p.impl == "mxu3":
        return ntt_mxu3(x, p.n, p.qs)
    return ntt_mxu(x, p.n, p.qs, p.impl == "mxu8")


def _intt_p(p, x):
    if p.impl == "vpu":
        return intt_negacyclic(x, p.n, p.qs)
    if p.impl == "mxu3":
        return intt_mxu3(x, p.n, p.qs)
    return intt_mxu(x, p.n, p.qs, p.impl == "mxu8")


def _reduce_u32(v, q, r16, r16s):
    """v mod q for arbitrary uint32 v (q > 2^16)."""
    ll, lh = _split(v)
    return _cond_sub(mulmod_shoup(lh, r16, r16s, q) + ll, q)


@lru_cache(maxsize=None)
def _fast_consts(p: FastParams):
    qs = p.qs
    L = len(qs)
    q = np.array(qs, dtype=np.uint32)[:, None]
    r16 = [(1 << 16) % qi for qi in qs]
    return {
        "q": q,
        "r16": np.array(r16, dtype=np.uint32)[:, None],
        "r16s": np.array(
            [shoup_const(w, qi) for w, qi in zip(r16, qs)], dtype=np.uint32
        )[:, None],
    }


# ---------------------------------------------------------------------------
# key / hint generation (host-side sampling, device-resident results)
# ---------------------------------------------------------------------------


def keygen(p: FastParams, rng: np.random.Generator, variance: float = 1.0):
    """Secret key in NTT domain: [L, n]."""
    s = gaussian_coeffs(rng, variance, p.n)
    s_res = jnp.asarray(np.stack([s % q for q in p.qs]).astype(np.uint32))
    return _ntt_p(p, s_res)


def shoup_precompute(arr, qs: tuple[int, ...]) -> tuple:
    """Host-side Shoup companions for runtime-constant device data (hints):
    returns (values, companions) for use with mulmod_shoup. `arr` has the
    limb axis second-to-last. Exact in uint64: v·2^32 < 2^64 for v < 2^32."""
    host = np.asarray(arr).astype(np.uint64)
    q = np.asarray(qs, dtype=np.uint64)[:, None]
    comp = ((host << np.uint64(32)) // q).astype(np.uint32)
    return jnp.asarray(np.asarray(arr)), jnp.asarray(comp)


@lru_cache(maxsize=None)
def _crt_gadget(p: FastParams):
    """CRT gadget g_i = Q_i·(Q_i^{-1} mod q_i) mod Q per row i, as its
    residues and Shoup companions [L(i), L, 1] (host numpy)."""
    Q = 1
    for q in p.qs:
        Q *= q
    g = [Q // qi * pow(Q // qi % qi, -1, qi) % Q for qi in p.qs]
    w = np.array([[gi % q for q in p.qs] for gi in g], dtype=np.uint32)
    ws = np.array([[shoup_const(gi % q, q) for q in p.qs] for gi in g],
                  dtype=np.uint32)
    return w[..., None], ws[..., None]


@partial(jax.jit, static_argnums=0)
def _relin_hint_rows(p: FastParams, s_ntt, a_res, e_res):
    """Rows B_i = g_i·s² + e_i − A_i·s, A_i = NTT(a_i): [L, L, n] each."""
    s2 = mulmod(s_ntt, s_ntt, p.qs)
    g, gs = _crt_gadget(p)
    a = _ntt_p(p, a_res)
    gs2 = mulmod_shoup(s2, g, gs, _fast_consts(p)["q"])
    b = _sub(_add(gs2, _ntt_p(p, e_res), p), mulmod(a, s_ntt, p.qs), p)
    return b, a


def relin_hint(p: FastParams, s_ntt, rng: np.random.Generator, variance: float = 1.0,
               shoup: bool = False):
    """CRT-gadget hint for s² under s: returns (B, A) each [L, L, n] in the
    NTT domain; row i satisfies B_i + A_i·s = g_i·s² + zp·e_i (mod Q).
    With shoup=True, each of B and A is a (values, companions) pair for the
    Shoup fast path in mul_relin. Sampling runs on the host, row by row;
    the arithmetic is one jitted program."""
    a_res, e_res = [], []
    for _ in p.qs:
        a_res.append(uniform_residues(rng, p.qs, p.n))
        e = gaussian_coeffs(rng, variance, p.n)
        e_res.append(np.stack([(e * p.zp) % q for q in p.qs]))
    B, A = _relin_hint_rows(p, s_ntt, jnp.asarray(np.stack(a_res).astype(np.uint32)),
                            jnp.asarray(np.stack(e_res).astype(np.uint32)))
    if shoup:
        return shoup_precompute(B, p.qs), shoup_precompute(A, p.qs)
    return B, A


def encrypt(p: FastParams, s_ntt, msg_coeffs: np.ndarray, rng: np.random.Generator,
            variance: float = 1.0):
    """Fresh ciphertext [2, L, n] (NTT domain) encrypting msg (mod zp)."""
    n = p.n
    lift = np.asarray(msg_coeffs, dtype=np.int64) % p.zp
    lift = np.where(lift > p.zp // 2, lift - p.zp, lift)
    mu = jnp.asarray(np.stack([lift % q for q in p.qs]).astype(np.uint32))
    mu_ntt = _ntt_p(p, mu)
    a = jnp.asarray(uniform_residues(rng, p.qs, n).astype(np.uint32))
    a_ntt = _ntt_p(p, a)
    e = gaussian_coeffs(rng, variance, n)
    pe = jnp.asarray(np.stack([(e * p.zp) % q for q in p.qs]).astype(np.uint32))
    pe_ntt = _ntt_p(p, pe)
    c0 = _sub(_add(mu_ntt, pe_ntt, p), mulmod(a_ntt, s_ntt, p.qs), p)
    return jnp.stack([c0, a_ntt])


def garner_host(coeff: np.ndarray, qs: tuple[int, ...]) -> list[np.ndarray]:
    """Vectorized mixed-radix (Garner) digits of the CRT values in
    `coeff[..., k, :]` — pure int64 numpy (every intermediate product is
    < q² < 2^62), no per-coefficient Python loop (VERDICT r3 weak #9:
    the host-exact paths dominated test/oracle wall-clock)."""
    L = len(qs)
    pi = [1]
    for g in qs[:-1]:
        pi.append(pi[-1] * g)
    xs = [np.asarray(coeff[..., 0, :], dtype=np.int64) % qs[0]]
    for k in range(1, L):
        g = qs[k]
        acc = xs[0] % g
        for j in range(1, k):
            acc = (acc + xs[j] * (pi[j] % g)) % g
        inv = pow(pi[k] % g, -1, g)
        xs.append(
            (np.asarray(coeff[..., k, :], dtype=np.int64) - acc) % g * inv % g)
    return xs


def _garner_centered_mod(coeff: np.ndarray, qs: tuple[int, ...],
                         m: int) -> np.ndarray:
    """(centered CRT lift of coeff) mod m, fully vectorized int64: digits,
    msd-first lexicographic centering vs Q//2, and the mod-m combination
    via π_k mod m — no big-int arithmetic anywhere."""
    L = len(qs)
    xs = garner_host(coeff, qs)
    pi = [1]
    for g in qs[:-1]:
        pi.append(pi[-1] * g)
    Q = pi[-1] * qs[-1]
    hd = []
    h = Q // 2
    for g in qs:
        hd.append(h % g)
        h //= g
    gt = np.zeros(xs[0].shape, dtype=bool)
    eq = np.ones(xs[0].shape, dtype=bool)
    for k in range(L - 1, -1, -1):
        gt |= eq & (xs[k] > hd[k])
        eq &= xs[k] == hd[k]
    v = np.zeros(xs[0].shape, dtype=np.int64)
    for k in range(L):
        v = (v + xs[k] % m * (pi[k] % m)) % m
    return np.where(gt, (v - Q % m) % m, v)


def decrypt(p: FastParams, s_ntt, ct) -> np.ndarray:
    """Host decrypt (exact CRT lift) → coefficients mod zp."""
    acc = ct[0]
    spow = None
    for k in range(1, ct.shape[0]):
        spow = s_ntt if spow is None else mulmod(spow, s_ntt, p.qs)
        acc = _add(acc, mulmod(ct[k], spow, p.qs), p)
    coeff = np.asarray(_intt_p(p, acc)).astype(np.int64)
    return _garner_centered_mod(np.moveaxis(coeff, 0, -2), p.qs, p.zp)


# ---------------------------------------------------------------------------
# the fused hot op
# ---------------------------------------------------------------------------


def _add(a, b, p: FastParams):
    return _cond_sub(a + b, _fast_consts(p)["q"])


def _sub(a, b, p: FastParams):
    q = _fast_consts(p)["q"]
    return jnp.where(a >= b, a - b, a + q - b)


@partial(jax.jit, static_argnums=0)
def mul_relin(p: FastParams, ct_a, ct_b, hint_b, hint_a):
    """Fused BGV multiply + relinearize: [..., 2, L, n] × [..., 2, L, n] →
    [..., 2, L, n] (leading batch dims supported; vmap-free batching).

    Inputs/outputs in the NTT domain at the full chain. Hints are either raw
    values [L, L, n] (general mulmod applied) or Shoup-precomputed pairs
    (values, companions) from `relin_hint(..., shoup=True)`, which drop the
    hint products to Shoup multiplies.
    """
    qs = p.qs
    L = len(qs)
    a0, a1 = ct_a[..., 0, :, :], ct_a[..., 1, :, :]
    b0, b1 = ct_b[..., 0, :, :], ct_b[..., 1, :, :]
    # Karatsuba: 3 general mulmods instead of 4 (each emulated 32×32→64
    # product costs four 16-bit multiplies; the extra adds/subs are cheap)
    c0 = mulmod(a0, b0, qs)
    c2 = mulmod(a1, b1, qs)
    cross = mulmod(_add(a0, a1, p), _add(b0, b1, p), qs)
    c1 = _sub(cross, _add(c0, c2, p), p)
    # CRT-gadget digits of c2: coefficients per limb, re-reduced to all limbs
    c2_coeff = _intt_p(p, c2)
    consts = _fast_consts(p)
    if p.impl != "vpu":
        # the digit-plane matmul computes Σ_b x_b·W[a,b] mod q exactly for
        # ANY uint32 input (planes are ≤ 255 regardless), so the per-limb
        # residues go into the NTT unreduced — the mod-q_j reduction of each
        # digit happens for free at matmul recombination; and the digit
        # fan-out across target limbs never materializes: the broadcast NTT
        # contracts the [..., Ldig, n] rows against every limb's matrices at
        # once (leading batch dims supported)
        if p.impl == "mxu3":
            dig_ntt = ntt_mxu3_bcast(c2_coeff, p.n, p.qs)  # [..., Ldig, L, n]
        else:
            dig_ntt = ntt_mxu_bcast(c2_coeff, p.n, p.qs, p.impl == "mxu8")
    else:
        # all digits at once: [..., Ldig, L, n]
        rows = c2_coeff[..., :, None, :]                  # [..., Ldig, 1, n]
        bc = jnp.broadcast_to(rows, (*c2_coeff.shape[:-2], L, L, p.n))
        dig = _reduce_u32(bc, consts["q"], consts["r16"], consts["r16s"])
        dig_ntt = _ntt_p(p, dig)        # one batched NTT
    out0, out1 = c0, c1
    q = consts["q"]
    shoup_hints = isinstance(hint_b, (tuple, list))
    for i in range(L):
        d = dig_ntt[..., i, :, :]
        if shoup_hints:
            out0 = _add(out0, mulmod_shoup(d, hint_b[0][i], hint_b[1][i], q), p)
            out1 = _add(out1, mulmod_shoup(d, hint_a[0][i], hint_a[1][i], q), p)
        else:
            out0 = _add(out0, mulmod(d, hint_b[i], qs), p)
            out1 = _add(out1, mulmod(d, hint_a[i], qs), p)
    return jnp.stack([out0, out1], axis=-3)


@lru_cache(maxsize=None)
def _rescale_consts(qs: tuple[int, ...]):
    """Constants for dropping the last limb q_k of `qs`, one row [Lk, 1] per
    kept limb q_j: q_j, 2^16 mod q_j, q_k mod q_j and q_k^{-1} mod q_j, the
    last three with Shoup companions (host numpy)."""
    qk, keep = qs[-1], qs[:-1]

    def col(vals):
        return np.array(vals, dtype=np.uint32)[:, None]

    def with_shoup(name, vals):
        return {name: col(vals),
                name + "s": col([shoup_const(v, q) for v, q in zip(vals, keep)])}

    return {"q": col(keep),
            **with_shoup("r16", [(1 << 16) % q for q in keep]),
            **with_shoup("qk", [qk % q for q in keep]),
            **with_shoup("inv", [pow(qk, -1, q) for q in keep])}


@partial(jax.jit, static_argnums=(0, 2))
def rescale(p: FastParams, ct, k_drop: int = 1):
    """Exact BGV rescale dropping the last k_drop limbs (NTT-domain in/out).

    Plaintext-scale bookkeeping is the caller's job (the chain primes are
    ≡ 1 mod zp in the benchmark configs, so the scale stays 1). Each drop is
    vectorized over the kept limbs (per-limb constants as [Lk, 1] columns)."""
    out = ct
    qs = tuple(p.qs)
    pz = p.zp
    mask = np.uint32(pz - 1)
    for _ in range(k_drop):
        coeff = _intt_p(FastParams(n=p.n, qs=qs, zp=pz, impl=p.impl), out)
        qk = qs[-1]
        c = _rescale_consts(qs)
        q = c["q"]
        r = coeff[..., -1:, :]                       # [..., 1, n]
        is_neg = r > np.uint32(qk // 2)
        r_mod_p = r & mask
        qk_mod_p = np.uint32(qk % pz)
        rc_mod_p = jnp.where(is_neg, (r_mod_p + pz - (qk_mod_p & mask)) & mask, r_mod_p)
        inv_qk_p = np.uint32(pow(qk, -1, pz))
        t = (((pz - rc_mod_p) & mask) * inv_qk_p) & mask  # (−r_c)·q_k^{-1} mod p
        t_neg = t > pz // 2
        r_red = _reduce_u32(r, q, c["r16"], c["r16s"])     # [..., Lk, n]
        qk_mod = c["qk"]
        rc = jnp.where(is_neg, jnp.where(r_red >= qk_mod, r_red - qk_mod,
                                         r_red + q - qk_mod), r_red)
        tc = jnp.where(t_neg, q - (np.uint32(pz) - t), t)
        delta = _cond_sub(rc + mulmod_shoup(tc, qk_mod, c["qks"], q), q)
        cj = coeff[..., :-1, :]
        diff = jnp.where(cj >= delta, cj - delta, cj + q - delta)
        out = mulmod_shoup(diff, c["inv"], c["invs"], q)
        qs = qs[:-1]
        out = _ntt_p(FastParams(n=p.n, qs=qs, zp=pz, impl=p.impl), out)
    return out
