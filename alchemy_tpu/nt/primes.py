"""NTT-friendly primes, roots of unity, and noise-unit accounting.

`units_of_modulus` reifies the reference's TH splice `mkModulus`
(Noise.hs:166-170): units = ⌊log2 q / 6.1⌋, the number of 6.1-bit noise units
a modulus can absorb in the PT2CT noise ledger.
"""

from __future__ import annotations

import math
from functools import lru_cache

from alchemy_tpu.nt.factor import factorize, is_prime, totient

#: "Bits" per noise unit (reference Noise.hs:153-155).
PNOISE_UNIT = 6.1


def units_of_modulus(q: int) -> int:
    """Noise units a modulus q can hold: ⌊log2(q) / 6.1⌋ (Noise.hs:166-170)."""
    return math.floor(math.log2(q) / PNOISE_UNIT)


def find_ntt_prime(m: int, bits: int, *, lo: bool = False, avoid: tuple[int, ...] = ()) -> int:
    """Find a prime q ≡ 1 (mod m) near 2^bits (searching downward, or upward
    from 2^(bits-1) when lo=True), excluding `avoid`.

    Such q admit primitive m-th roots of unity, enabling the full CRT/NTT
    transform of the m-th cyclotomic ring over Z_q.
    """
    if lo:
        q = ((1 << (bits - 1)) // m) * m + 1
        step = m
    else:
        q = ((1 << bits) // m) * m + 1
        step = -m
    while 2 < q < (1 << 32):
        if q not in avoid and is_prime(q):
            return q
        q += step
    raise ValueError(f"no NTT prime ≡ 1 mod {m} near 2^{bits}")


@lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest primitive root mod prime q."""
    if not is_prime(q):
        raise ValueError(f"{q} is not prime")
    phi = q - 1
    fac = [p for p, _ in factorize(phi)]
    for g in range(2, q):
        if all(pow(g, phi // p, q) != 1 for p in fac):
            return g
    raise ArithmeticError(f"no primitive root mod {q}")


@lru_cache(maxsize=None)
def root_of_unity(m: int, q: int) -> int:
    """A fixed primitive m-th root of unity mod prime q (requires m | q-1).

    Deterministic: derived from the smallest primitive root of q, so every
    backend (golden, jnp, native) builds identical transform matrices.
    """
    if m == 1:
        return 1
    if (q - 1) % m != 0:
        raise ValueError(f"q={q} is not ≡ 1 mod m={m}; no m-th root of unity")
    g = primitive_root(q)
    w = pow(g, (q - 1) // m, q)
    assert pow(w, m, q) == 1 and pow(w, m // p_smallest(m), q) != 1
    return w


def p_smallest(m: int) -> int:
    return factorize(m)[0][0]


def validate_moduli_for_ring(m: int, qs: list[int]) -> None:
    """Every ciphertext modulus must be ≡ 1 (mod m) to support the CRT
    transform of the m-th cyclotomic ring."""
    for q in qs:
        if (q - 1) % m != 0:
            raise ValueError(
                f"modulus {q} is not NTT-friendly for cyclotomic index {m} "
                f"(need q ≡ 1 mod {m})"
            )
