"""Hybrid key-switching (dnum digit groups + special modulus) for deep chains.

The reference's key-switch gadgets (TrivGad / BaseBGad, PT2CT.hs:136-140)
decompose over every RNS limb: relinearization at an L-limb chain runs L
digit NTTs per output limb — L² limb-transforms (she/fast.py mul_relin).
Hybrid key-switching (the RNS technique of Han-Ki / "better bootstrapping",
standard in modern RNS-FHE libraries) groups the chain into `dnum` digits of
α = ⌈L/dnum⌉ limbs each and key-switches over the extended modulus Q·P,
where the special modulus P = ∏ ps has K ≈ α limbs:

  digits:   D_j ≡ c2 (mod Q_j),  |D_j| < Q_j = ∏ of group j's limbs,
            computed EXACTLY by Garner mixed-radix lifting (integer-only —
            no floating-point base-extension estimate, so every backend is
            bit-identical);
  hint j:   B_j + A_j·s = P·ĝ_j·s² + zp·e_j (mod QP), ĝ_j the CRT factor
            of Q over the group moduli (she/gadget.py _crt_gadget_factors
            generalized to limb groups);
  combine:  (t0, t1) = Σ_j D_j·(B_j, A_j) over Q·P, then one exact joint
            rescale by P (`rescale_joint`) back to Q, added to (c0, c1).

Work at an L-limb chain with T = L + K extended limbs:
  limb-transforms: L (iNTT) + dnum·T (digit NTTs) + 2T (iNTT) + 2L (NTT)
  vs TrivGad's L + L²; hint products 2·dnum·T vs 2·L².
At L = 16 (dnum = 4, K = 4): 168 vs 272 transforms (1.6×) and 160 vs 512
hint products (3.2×). At the north-star L = 8 the transform counts tie —
hybrid pays off at deep configurations, as chosen per config by `pick_dnum`.
Noise: the per-switch noise is Σ_j D_j·zp·e_j / P + rounding ≈ dnum·zp·|e|
(digit magnitude cancels against P), vs L·q_max·zp·|e| for TrivGad — hybrid
is strictly noise-cheaper whenever P ≥ max Q_j.

Semantics pinned by the same differential oracle as every SHE op:
decrypt(mul_relin_hybrid(enc a, enc b)) == a·b (tests/test_hybrid.py).
Reference parity: this implements the `keySwitchQuadCirc` semantics
(consumed at /root/reference Crypto/Alchemy/Interpreter/Eval.hs:126,133)
with a gadget the reference doesn't have — a deliberate new first-class
component (SURVEY.md §2.4: perf/scaling axes are first-class here).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from alchemy_tpu.backend.xla import _cond_sub, mulmod, mulmod_shoup, shoup_const
from alchemy_tpu.nt.primes import find_ntt_prime
from alchemy_tpu.she.fast import (
    FastParams,
    _add,
    _fast_consts,
    _intt_p,
    _ntt_p,
    _sub,
)
from alchemy_tpu.she.keys import gaussian_coeffs, uniform_residues


def _smod(a, w_int: int, q_int: int):
    """a·w mod q for a python-int constant w and modulus q, any uint32 a."""
    return mulmod_shoup(a, np.uint32(w_int % q_int),
                        np.uint32(shoup_const(w_int % q_int, q_int)),
                        np.uint32(q_int))


def _submod_q(a, b, q):
    """a − b mod q for a, b < q; q an int or a uint32 array."""
    q = np.asarray(q, dtype=np.uint32)
    return jnp.where(a >= b, a - b, a + q - b)


# ---------------------------------------------------------------------------
# Garner mixed-radix lifting (exact, integer-only)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _garner_tables(chain: tuple[int, ...]):
    """Host tables for mixed-radix digits over `chain`: pi[k] = ∏_{j<k} g_j
    (exact ints) and inv[k] = pi[k]^{-1} mod g_k."""
    pi = [1]
    for g in chain[:-1]:
        pi.append(pi[-1] * g)
    inv = [1] + [pow(pi[k] % chain[k], -1, chain[k]) for k in range(1, len(chain))]
    return tuple(pi), tuple(inv)


def garner_digits(res, chain: tuple[int, ...]):
    """Mixed-radix digits x_k of the value V ∈ [0, ∏chain) with residues
    `res[..., k, :]` mod chain[k]: V = Σ_k x_k·π_k, 0 ≤ x_k < chain[k].
    Exact and integer-only (deterministic across backends)."""
    pi, inv = _garner_tables(chain)
    xs = [res[..., 0, :]]
    for k in range(1, len(chain)):
        g = chain[k]
        # V_{k-1} mod g_k = Σ_{j<k} x_j·π_j  (π_0 = 1 reduces x_0 mod g_k)
        acc = _smod(xs[0], 1, g)
        for j in range(1, k):
            acc = _cond_sub(acc + _smod(xs[j], pi[j], g), np.uint32(g))
        xs.append(_smod(_submod_q(res[..., k, :], acc, g), inv[k], g))
    return xs


@lru_cache(maxsize=None)
def _extend_consts(chain: tuple[int, ...], targets: tuple[int, ...]):
    """[π_k]_{q_t} Shoup pairs, shaped [T, 1] for broadcasting (host numpy)."""
    pi, _ = _garner_tables(chain)
    w = np.array([[p % q for q in targets] for p in pi], dtype=np.uint32)
    ws = np.array(
        [[shoup_const(p % q, q) for q in targets] for p in pi], dtype=np.uint32
    )
    q = np.array(targets, dtype=np.uint32)
    return w[..., None], ws[..., None], q[:, None]


def extend_digits(xs, chain: tuple[int, ...], targets: tuple[int, ...]):
    """Residues of V = Σ_k x_k·π_k modulo every target limb:
    [..., n] digits → [..., T, n]."""
    w, ws, q = _extend_consts(chain, targets)
    out = None
    for k, x in enumerate(xs):
        term = mulmod_shoup(x[..., None, :], w[k], ws[k], q)
        out = term if out is None else _cond_sub(out + term, q)
    return out


# ---------------------------------------------------------------------------
# joint rescale: drop the last k limbs in ONE iNTT/NTT round trip
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 2))
def rescale_joint(p: FastParams, ct, k_drop: int):
    """Exact BGV rescale by P = ∏ of the last k_drop limbs, in one inverse/
    forward NTT round trip (fast.rescale iterates limb-by-limb, paying a
    round trip per limb — the rounding differs by the same documented
    deviation, exactness and noise bounds identical).

    ct: [..., T, n] NTT domain → [..., T-k_drop, n]. Requires zp a power of
    two (all reference configs) and chain primes ≡ 1 mod zp (NTT primes)."""
    qs = p.qs
    keep, drop = qs[:-k_drop], qs[-k_drop:]
    pz = p.zp
    if pz & (pz - 1) or pz > (1 << 16):
        # the V-mod-zp accumulator below multiplies two values < zp in
        # uint32 lanes — zp ≤ 2^16 keeps the product exact
        raise ValueError("rescale_joint requires a power-of-two zp <= 2^16")
    P = 1
    for g in drop:
        P *= g
    coeff = _intt_p(p, ct)
    r = coeff[..., len(keep):, :]
    xs = garner_digits(r, drop)

    # is_neg: V > P//2 — lexicographic compare of mixed-radix digits
    pi, _ = _garner_tables(drop)
    hd = []
    h = P // 2
    for g in drop:
        hd.append(h % g)
        h //= g
    gt = jnp.zeros(xs[0].shape, dtype=bool)
    eq = jnp.ones(xs[0].shape, dtype=bool)
    for k in range(len(drop) - 1, -1, -1):
        gt = gt | (eq & (xs[k] > np.uint32(hd[k])))
        eq = eq & (xs[k] == np.uint32(hd[k]))
    is_neg = gt

    # centered V mod zp, then t ≡ (−V_c)·P^{-1} (mod zp), centered
    mask = np.uint32(pz - 1)
    vz = jnp.zeros_like(xs[0])
    for k, x in enumerate(xs):
        vz = (vz + (x & mask) * np.uint32(pi[k] % pz)) & mask
    vz = jnp.where(is_neg, (vz + np.uint32(pz) - np.uint32(P % pz)) & mask, vz)
    inv_P_zp = pow(P % pz, -1, pz) if pz > 1 else 0
    t = (((np.uint32(pz) - vz) & mask) * np.uint32(inv_P_zp)) & mask
    t_neg = t > pz // 2

    # per kept limb q_j, vectorized over [Lk, 1] constant columns
    def col(vals):
        return np.array(vals, dtype=np.uint32)[:, None]

    q = col(keep)
    p_mod = col([P % qj for qj in keep])
    p_mod_s = col([shoup_const(P % qj, qj) for qj in keep])
    inv_p = col([pow(P % qj, -1, qj) for qj in keep])
    inv_p_s = col([shoup_const(pow(P % qj, -1, qj), qj) for qj in keep])
    is_neg, t, t_neg = is_neg[..., None, :], t[..., None, :], t_neg[..., None, :]
    vq = extend_digits(xs, drop, keep)                  # [..., Lk, n]
    vq = jnp.where(is_neg, _submod_q(vq, p_mod, q), vq)
    tc = jnp.where(t_neg, q - (np.uint32(pz) - t), t)
    delta = _cond_sub(vq + mulmod_shoup(tc, p_mod, p_mod_s, q), q)
    diff = _submod_q(coeff[..., :len(keep), :], delta, q)
    out = mulmod_shoup(diff, inv_p, inv_p_s, q)
    return _ntt_p(FastParams(n=p.n, qs=keep, zp=p.zp, impl=p.impl), out)


# ---------------------------------------------------------------------------
# hybrid key-switch parameters, keygen/hint, fused mul+relin
# ---------------------------------------------------------------------------


def pick_dnum(L: int) -> int:
    """Smallest dnum with α = ⌈L/dnum⌉ ≤ 4 — transform-count sweet spot
    (α > 4 inflates K and the P-rescale; α < 2 degenerates to TrivGad)."""
    return max(1, (L + 3) // 4)


@dataclass(frozen=True)
class HybridKS:
    """Static hybrid-KS configuration over a FastParams chain."""

    p: FastParams
    dnum: int
    ps: tuple[int, ...]       # special-modulus limbs, P = ∏ ps

    @staticmethod
    def make(p: FastParams, dnum: int | None = None, k_sp: int | None = None,
             bits: int | None = None) -> "HybridKS":
        L = len(p.qs)
        dnum = pick_dnum(L) if dnum is None else dnum
        alpha = -(-L // dnum)
        # normalize: the digit count is the GROUP count ⌈L/α⌉, which can be
        # smaller than a caller-supplied dnum (e.g. dnum=3 at L=4 → α=2 →
        # 2 groups); every loop below must agree with len(groups)
        dnum = -(-L // alpha)
        k_sp = alpha if k_sp is None else k_sp
        # the hybrid noise bound needs P ≥ max Q_j — start the special
        # primes at the chain's own width and widen until it holds
        if bits is None:
            bits = max(q.bit_length() for q in p.qs)
        max_Qj = 0
        for i in range(0, L, alpha):
            Qj = 1
            for g in p.qs[i:i + alpha]:
                Qj *= g
            max_Qj = max(max_Qj, Qj)
        while True:
            ps: list[int] = []
            while len(ps) < k_sp:
                ps.append(
                    find_ntt_prime(2 * p.n, bits, avoid=tuple(p.qs) + tuple(ps)))
            P = 1
            for g in ps:
                P *= g
            if P >= max_Qj or bits >= 31:
                break
            bits += 1
        return HybridKS(p=p, dnum=dnum, ps=tuple(ps))

    @property
    def pe(self) -> FastParams:
        return FastParams(n=self.p.n, qs=self.p.qs + self.ps, zp=self.p.zp,
                          impl=self.p.impl)

    @property
    def groups(self) -> tuple[tuple[int, ...], ...]:
        L = len(self.p.qs)
        alpha = -(-L // self.dnum)
        return tuple(
            tuple(self.p.qs[i:i + alpha]) for i in range(0, L, alpha)
        )


def hybrid_keygen_hint(hk: HybridKS, rng: np.random.Generator,
                       variance: float = 1.0, hint_variance: float = 1.0):
    """Secret key (NTT domain at the base chain, fast.keygen-compatible)
    plus the hybrid relinearization hint (B, A), each [dnum, T, n] in the
    NTT domain at the extended chain: B_j + A_j·s = P·ĝ_j·s² + zp·e_j."""
    s = gaussian_coeffs(rng, variance, hk.p.n)
    s_ntt = _ntt_p(hk.p, jnp.asarray(
        np.stack([s % q for q in hk.p.qs]).astype(np.uint32)))
    return s_ntt, hybrid_relin_hint(hk, s, rng, hint_variance)


def hybrid_relin_hint(hk: HybridKS, s_coeffs: np.ndarray,
                      rng: np.random.Generator, hint_variance: float = 1.0):
    """Hybrid relinearization hint for a given secret key (centered integer
    coefficients): (B, A) each [dnum, T, n], NTT domain, extended chain.
    Sampling runs on the host, group by group; the arithmetic is one
    jitted program."""
    p, pe = hk.p, hk.pe
    n = p.n
    s = np.asarray(s_coeffs, dtype=np.int64)
    a_res, e_res = [], []
    for _ in hk.groups:
        a_res.append(uniform_residues(rng, pe.qs, n))
        e = gaussian_coeffs(rng, hint_variance, n)
        e_res.append(np.stack([(e * p.zp) % q for q in pe.qs]))
    s_res = np.stack([s % q for q in pe.qs]).astype(np.uint32)
    return _hybrid_hint_rows(hk, jnp.asarray(s_res),
                             jnp.asarray(np.stack(a_res).astype(np.uint32)),
                             jnp.asarray(np.stack(e_res).astype(np.uint32)))


@lru_cache(maxsize=None)
def _hybrid_gadget(hk: HybridKS):
    """ĝ_j scaled by P per group j, as residues and Shoup companions over
    the extended chain, [dnum, T, 1] (host numpy)."""
    p, pe = hk.p, hk.pe
    Q = 1
    for q in p.qs:
        Q *= q
    P = 1
    for g in hk.ps:
        P *= g
    w, ws = [], []
    for grp in hk.groups:
        Qj = 1
        for g in grp:
            Qj *= g
        Qi = Q // Qj
        g_j = P * (Qi * pow(Qi % Qj, -1, Qj) % Q) % (Q * P)
        w.append([g_j % q for q in pe.qs])
        ws.append([shoup_const(g_j % q, q) for q in pe.qs])
    return (np.array(w, dtype=np.uint32)[..., None],
            np.array(ws, dtype=np.uint32)[..., None])


@partial(jax.jit, static_argnums=0)
def _hybrid_hint_rows(hk: HybridKS, s_res, a_res, e_res):
    """B_j = P·ĝ_j·s² + e_j − A_j·s, A_j = NTT(a_j) over the extended
    chain: [dnum, T, n] each."""
    pe = hk.pe
    s_e = _ntt_p(pe, s_res)
    s2_e = mulmod(s_e, s_e, pe.qs)
    g, gs = _hybrid_gadget(hk)
    a = _ntt_p(pe, a_res)
    gs2 = mulmod_shoup(s2_e, g, gs, _fast_consts(pe)["q"])
    b = _sub(_add(gs2, _ntt_p(pe, e_res), pe), mulmod(a, s_e, pe.qs), pe)
    return b, a


@partial(jax.jit, static_argnums=0)
def mul_relin_hybrid(hk: HybridKS, ct_a, ct_b, hint_b, hint_a):
    """Fused BGV multiply + hybrid relinearization: [..., 2, L, n] cts in
    the NTT domain at the base chain → same. Bit-exact semantics (decrypt
    equals the plaintext product — the §4 differential oracle)."""
    p, pe = hk.p, hk.pe
    qs = p.qs
    a0, a1 = ct_a[..., 0, :, :], ct_a[..., 1, :, :]
    b0, b1 = ct_b[..., 0, :, :], ct_b[..., 1, :, :]
    c0 = mulmod(a0, b0, qs)
    c2 = mulmod(a1, b1, qs)
    cross = mulmod(_add(a0, a1, p), _add(b0, b1, p), qs)
    c1 = _sub(cross, _add(c0, c2, p), p)

    c2_coeff = _intt_p(p, c2)
    digs = []
    off = 0
    for grp in hk.groups:
        xs = garner_digits(c2_coeff[..., off:off + len(grp), :], grp)
        digs.append(extend_digits(xs, grp, pe.qs))
        off += len(grp)
    dig = jnp.stack(digs, axis=-3)          # [..., dnum, T, n]
    dig_ntt = _ntt_p(pe, dig)

    t0 = t1 = None
    shoup_hints = isinstance(hint_b, (tuple, list))
    qe = _fast_consts(pe)["q"]
    for j in range(len(hk.groups)):
        d = dig_ntt[..., j, :, :]
        if shoup_hints:
            u0 = mulmod_shoup(d, hint_b[0][j], hint_b[1][j], qe)
            u1 = mulmod_shoup(d, hint_a[0][j], hint_a[1][j], qe)
        else:
            u0 = mulmod(d, hint_b[j], pe.qs)
            u1 = mulmod(d, hint_a[j], pe.qs)
        t0 = u0 if t0 is None else _add(t0, u0, pe)
        t1 = u1 if t1 is None else _add(t1, u1, pe)

    r01 = rescale_joint(pe, jnp.stack([t0, t1], axis=-3), len(hk.ps))
    out0 = _add(c0, r01[..., 0, :, :], p)
    out1 = _add(c1, r01[..., 1, :, :], p)
    return jnp.stack([out0, out1], axis=-3)
