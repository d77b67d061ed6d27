"""Cyclotomic ring structure: the tensor decomposition of R_m = Z[ζ_m].

For m = ∏ p_i^{e_i}, R_m ≅ ⊗_i R_{p_i^{e_i}}; an element is an array whose
axes are the per-factor powerful bases (axis i has length φ(p_i^{e_i})).
Every basis change, subring embedding, and trace is then *per-axis*:

- powerful → CRT ("slots"): per-axis matmul with the per-factor DFT submatrix
  [ω^{u·j}] over Z_q (q ≡ 1 mod m), u running over the canonical unit order.
- CRT slot order per factor: powers g^j of a fixed primitive root (odd p;
  g chosen primitive mod p² so the choice is consistent across exponents), and
  (−1)^s·5^j for 2-powers. With these orders, restriction (Z/p^a)* → (Z/p^b)*
  is index-truncation, so subring embed = broadcast and twace = weighted fiber
  sum along *reshaped* axes — pure data movement on the device, no gathers.
- twace is the integral "tweaked trace" Tw(x) = (m̂/m̂')·Tr(x·g'/g) with
  g = ∏_{odd p|m}(1−ζ_p) (the λ∘λ normalization Lol uses; plain normalized
  trace is not integral). Its per-axis matrices have exact closed forms via
  Ramanujan sums Tr(ζ_n^t) = μ(n/d)·φ(n)/φ(n/d), d = gcd(n,t); we build them
  as exact rationals and verify integrality.

Reference counterpart: Lol's `Cyc`/`Factored` tensor algebra and lol-cpp's
basis transforms (consumed surface in SURVEY.md §2.3). Here transforms are
matmul chains the accelerator runs on its tensor cores, not C++ loops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from alchemy_tpu.nt.factor import (
    factorize,
    factor_unit_order,
    totient,
)
from alchemy_tpu.nt.primes import root_of_unity

# ---------------------------------------------------------------------------
# Exact scalar number theory helpers
# ---------------------------------------------------------------------------


def mobius(n: int) -> int:
    fac = factorize(n)
    if any(e > 1 for _, e in fac):
        return 0
    return -1 if len(fac) % 2 else 1


def trace_zeta(n: int, t: int) -> int:
    """Tr_{Q(ζ_n)/Q}(ζ_n^t) = μ(n/d)·φ(n)/φ(n/d) with d = gcd(n, t)."""
    if n == 1:
        return 1
    d = math.gcd(n, t % n)
    nd = n // d
    return mobius(nd) * totient(n) // totient(nd)


# ---------------------------------------------------------------------------
# Per-factor matrices (exact, host-side)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def crt_factor_matrix(pe: int, q: int) -> np.ndarray:
    """DFT submatrix M[u_idx, j] = ω^{u·j} mod q for factor p^e: maps
    powerful-basis coefficients (axis j) to CRT slot values (axis u)."""
    phi = totient(pe)
    w = root_of_unity(pe, q)
    order = factor_unit_order(pe)
    M = np.empty((phi, phi), dtype=np.int64)
    for ui, u in enumerate(order):
        wu = pow(w, u, q)
        val = 1
        for j in range(phi):
            M[ui, j] = val
            val = val * wu % q
    return M


@lru_cache(maxsize=None)
def icrt_factor_matrix(pe: int, q: int) -> np.ndarray:
    """Inverse of `crt_factor_matrix` mod q (exact Gaussian elimination)."""
    M = crt_factor_matrix(pe, q)
    return _invert_mod(M, q)


def _invert_mod(M: np.ndarray, q: int) -> np.ndarray:
    n = M.shape[0]
    A = [[int(M[i, j]) for j in range(n)] for i in range(n)]
    inv = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next((r for r in range(col, n) if A[r][col] % q != 0), None)
        if piv is None:
            raise ArithmeticError(f"matrix not invertible mod {q}")
        A[col], A[piv] = A[piv], A[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        s = pow(A[col][col], -1, q)
        A[col] = [a * s % q for a in A[col]]
        inv[col] = [a * s % q for a in inv[col]]
        for r in range(n):
            if r != col and A[r][col]:
                f = A[r][col]
                A[r] = [(a - f * b) % q for a, b in zip(A[r], A[col])]
                inv[r] = [(a - f * b) % q for a, b in zip(inv[r], inv[col])]
    return np.array(inv, dtype=np.int64)


@lru_cache(maxsize=None)
def power_reduction_matrix(pe: int) -> np.ndarray:
    """Integer matrix [p^e, φ(p^e)] expressing ζ_{p^e}^t in the powerful basis
    (x^j, j < φ). Uses Φ_{p^e}(x) = Σ_{i<p} x^{i·p^{e-1}}."""
    fac = factorize(pe)
    (p, e) = fac[0]
    phi = totient(pe)
    step = p ** (e - 1)
    rows = np.zeros((pe, phi), dtype=np.int64)
    for t in range(phi):
        rows[t, t] = 1
    # reduce t = phi .. pe-1 downward: x^phi = -(x^0 + x^step + .. + x^{(p-2)step})
    for t in range(phi, pe):
        # x^t = x^{t-phi} * x^{phi}
        base = t - phi
        acc = np.zeros(phi, dtype=np.int64)
        for i in range(p - 1):
            tt = base + i * step
            acc -= rows[tt]
        rows[t] = acc
    return rows


@lru_cache(maxsize=None)
def twace_factor_matrix(p: int, a: int, b: int) -> np.ndarray:
    """Exact integer matrix [φ(p^b), φ(p^a)] of the tweaked trace Tw on one
    tensor axis: R_{p^a}-axis → R_{p^b}-axis (b may be 0: output length 1).

    For b >= 1 (same prime retained): Tw(x^{j'}) = x^{j'/p^{a-b}} when
    p^{a-b} | j', else 0 (pure subselection). For b = 0 (prime removed):
    Tw(x^{j'}) = (1/p^a-hat)·Tr((1−ζ_p)·ζ_{p^a}^{j'}) for odd p, and
    (1/ m̂-ratio)·Tr(ζ_{2^a}^{j'}) for p = 2 — closed forms via `trace_zeta`.
    """
    pa = p**a
    phi_a = totient(pa)
    if b >= 1:
        pb = p**b
        phi_b = totient(pb)
        ratio = p ** (a - b)
        M = np.zeros((phi_b, phi_a), dtype=np.int64)
        for j in range(phi_a):
            if j % ratio == 0:
                M[j // ratio, j] = 1
        return M
    # b == 0: removed prime
    M = np.zeros((1, phi_a), dtype=np.int64)
    if p == 2:
        # m̂ ratio: removing the full 2-part changes m̂ by pa/2 (m̂ = m/2 for
        # even m); no g-factor for p = 2.
        denom = pa // 2 if a >= 1 else 1
        for j in range(phi_a):
            num = trace_zeta(pa, j)
            # relative trace values divided by denom must be integral
            if num % denom:
                raise ArithmeticError("non-integral twace entry (p=2)")
            M[0, j] = num // denom
        return M
    denom = pa  # m̂ multiplies by pa for odd p
    for j in range(phi_a):
        # Tr((1 − ζ_p)·ζ_{p^a}^j) = Tr(ζ^j) − Tr(ζ^{j + p^{a-1}})
        num = trace_zeta(pa, j) - trace_zeta(pa, j + p ** (a - 1))
        if num % denom:
            raise ArithmeticError("non-integral twace entry (odd p)")
        M[0, j] = num // denom
    return M


# ---------------------------------------------------------------------------
# CycRing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FactorInfo:
    p: int
    e: int

    @property
    def pe(self) -> int:
        return self.p**self.e

    @property
    def phi(self) -> int:
        return totient(self.pe)


class CycRing:
    """Static structure of the m-th cyclotomic ring."""

    def __init__(self, m: int):
        if m < 1:
            raise ValueError("cyclotomic index must be >= 1")
        self.m = m
        self.factors = tuple(FactorInfo(p, e) for p, e in factorize(m))
        self.phi = totient(m)
        #: per-factor axis lengths, in ascending-prime order
        self.shape = tuple(f.phi for f in self.factors) or (1,)

    @property
    def naxes(self) -> int:
        return max(len(self.factors), 1)

    def __repr__(self):
        return f"CycRing(m={self.m}, phi={self.phi})"

    # -- transforms ---------------------------------------------------------

    def crt_mats(self, q: int) -> list[np.ndarray]:
        """Per-axis powerful→CRT matrices mod q."""
        if not self.factors:
            return [np.ones((1, 1), dtype=np.int64)]
        return [crt_factor_matrix(f.pe, q) for f in self.factors]

    def icrt_mats(self, q: int) -> list[np.ndarray]:
        if not self.factors:
            return [np.ones((1, 1), dtype=np.int64)]
        return [icrt_factor_matrix(f.pe, q) for f in self.factors]

    # -- slot bookkeeping ---------------------------------------------------

    def slot_exponents(self) -> list[int]:
        """Global CRT slot exponents (elements of (Z/m)^*) in storage order:
        the CRT recombination of per-factor orders, first factor slowest."""
        from alchemy_tpu.nt.factor import crt_index_set

        return crt_index_set(self.m)

    # -- subring structure (m_sub | m) --------------------------------------

    def factor_exponent(self, p: int) -> int:
        for f in self.factors:
            if f.p == p:
                return f.e
        return 0

    def check_subring(self, sub: "CycRing") -> None:
        if self.m % sub.m != 0:
            raise ValueError(f"{sub.m} does not divide {self.m}")


@lru_cache(maxsize=None)
def get_ring(m: int) -> CycRing:
    return CycRing(m)
