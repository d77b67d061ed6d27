"""3-factor matmul negacyclic NTT: n = A·B·r with A = B = 128 and r ∈ {1,2,4}.

The 2-factor matmul NTT (backend/ntt_mxu.py) costs n·(n1+n2) base MACs per
limb with n1+n2 = 384 at n = 2^15 (256·128). Factoring the lane axis once
more — A·B matmul factors of 128 plus a tiny radix-r DFT done elementwise —
cuts that to n·(A+B) = n·256 at 2^15 and n·256 (+cheap radix-4) at 2^16:
1.5–2× less matmul work. Slot order differs from ntt_mxu (each impl's
order is fixed and self-consistent; all SHE ops are pointwise in the NTT
domain — DESIGN.md).

Index plan (forward): j = j1·(B·r) + j3·B + j2, natural order reshaped to
rows j1 (sublanes), lanes j3·B + j2.

  stage 1 (matmul): contract j1 with W1[k1,j1] = w^{Br·j1·k1}·ψ^{j1·Br}
  twiddle  (elementwise): T[k1, j3·B+j2] = w^{k1·(j3B+j2)}·ψ^{j3B+j2}
  radix-r  (elementwise): DFT_r over j3 (u^{B}-powers are r-th roots; for r=2 a
      single add/sub pair), then the small twiddle u^{j2·k3} on the k3 ≥ 1
      halves (u = w^{A})
  stage 3 (matmul): DFT_B over j2 with root u^{r}, one [·,B]@[B,B] dot per k3

Output slot layout: position k1·(B·r) + k3·B + k2. All matrices are applied
as exact digit-plane bf16 matmuls (scaled planes, one reduction per stage —
see backend/ntt_mxu.py).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from alchemy_tpu.backend.ntt_mxu import (
    _matmul_mod,
    _matmul_mod_bcast,
    scaled_planes,
)
from alchemy_tpu.backend.xla import _cond_sub, mulmod_shoup, shoup_const
from alchemy_tpu.nt.primes import root_of_unity

A_FACTOR = 128
B_FACTOR = 128


def _split3(n: int) -> tuple[int, int, int]:
    """n = A·B·r with A = B = 2^k ≤ 128 and the radix r ∈ {1, 2, 4} as small
    as possible (r > 1 only once A and B saturate at 128)."""
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"ring size {n} is not a power of two")
    for r in (1, 2, 4):
        rest = log_n - (r.bit_length() - 1)
        if rest % 2 == 0 and rest // 2 <= 7:
            A = B = 1 << (rest // 2)
            return A, B, r
    raise ValueError(f"ring size {n}: no A=B≤128, r∈(1,2,4) split")


@lru_cache(maxsize=None)
def mxu3_tables(n: int, qs: tuple[int, ...]):
    """Host tables (cached numpy; device constants bake per-trace)."""
    A, B, r = _split3(n)
    L = len(qs)
    W1 = np.empty((L, A, A), dtype=np.int64)
    W1i = np.empty((L, A, A), dtype=np.int64)
    W2 = np.empty((L, B, B), dtype=np.int64)    # root u^r (order B)
    W2i = np.empty((L, B, B), dtype=np.int64)
    T = np.empty((L, A, B * r), dtype=np.uint32)
    T_s = np.empty((L, A, B * r), dtype=np.uint32)
    Ti = np.empty((L, A, B * r), dtype=np.uint32)
    Ti_s = np.empty((L, A, B * r), dtype=np.uint32)
    # small twiddles u^{j2·k3} for k3 = 1..r-1, laid out as one [A?, no —
    # [r, B] lane rows (k3 = 0 row is all-ones, kept for uniform code)
    tb = np.empty((L, r, B), dtype=np.uint32)
    tb_s = np.empty((L, r, B), dtype=np.uint32)
    tbi = np.empty((L, r, B), dtype=np.uint32)
    tbi_s = np.empty((L, r, B), dtype=np.uint32)
    for li, q in enumerate(qs):
        psi = root_of_unity(2 * n, q)
        w = psi * psi % q
        u = pow(w, A, q)
        ur = pow(u, r, q)
        uri = pow(ur, -1, q)
        w1 = pow(w, B * r, q)
        w1i = pow(w1, -1, q)
        psi_i = pow(psi, -1, q)
        n_inv = pow(n, -1, q)
        for a in range(A):
            for b in range(A):
                W1[li, a, b] = pow(w1, a * b, q) * pow(psi, b * B * r, q) % q
                W1i[li, a, b] = (
                    pow(w1i, a * b, q) * pow(psi_i, a * B * r, q) * n_inv % q
                )
        for a in range(B):
            for b in range(B):
                W2[li, a, b] = pow(ur, a * b, q)
                W2i[li, a, b] = pow(uri, a * b, q)
        for k1 in range(A):
            for m in range(B * r):
                v = pow(w, k1 * m, q) * pow(psi, m, q) % q
                T[li, k1, m] = v
                T_s[li, k1, m] = (v << 32) // q
                iv = pow(pow(w, k1 * m, q), -1, q) * pow(psi_i, m, q) % q
                Ti[li, k1, m] = iv
                Ti_s[li, k1, m] = (iv << 32) // q
        ui = pow(u, -1, q)
        for k3 in range(r):
            for j2 in range(B):
                v = pow(u, j2 * k3, q)
                tb[li, k3, j2] = v
                tb_s[li, k3, j2] = (v << 32) // q
                iv = pow(ui, j2 * k3, q)
                tbi[li, k3, j2] = iv
                tbi_s[li, k3, j2] = (iv << 32) // q

    def planes(M):
        return np.stack([scaled_planes(M[li], qs[li]) for li in range(L)])

    qcol = np.array(qs, dtype=np.uint32)[:, None, None]
    r32 = np.array([(1 << 32) % q for q in qs], dtype=np.uint32)[:, None, None]
    r32s = np.array(
        [shoup_const((1 << 32) % q, q) for q in qs], dtype=np.uint32
    )[:, None, None]
    r16 = np.array([(1 << 16) % q for q in qs], dtype=np.uint32)[:, None, None]
    r16s = np.array(
        [shoup_const((1 << 16) % q, q) for q in qs], dtype=np.uint32
    )[:, None, None]
    # r-th roots of unity u^{B·j3·k3} for the elementwise DFT_r (host ints per limb)
    urth = np.empty((L, r, r), dtype=np.uint32)
    urth_s = np.empty((L, r, r), dtype=np.uint32)
    urth_i = np.empty((L, r, r), dtype=np.uint32)
    urth_is = np.empty((L, r, r), dtype=np.uint32)
    for li, q in enumerate(qs):
        psi = root_of_unity(2 * n, q)
        w = pow(psi, 2, q)
        uB = pow(w, A * B, q)   # order r
        uBi = pow(uB, -1, q)
        for a in range(r):
            for b in range(r):
                v = pow(uB, a * b, q)
                urth[li, a, b] = v
                urth_s[li, a, b] = (v << 32) // q
                iv = pow(uBi, a * b, q)
                urth_i[li, a, b] = iv
                urth_is[li, a, b] = (iv << 32) // q
    return {
        "A": A, "B": B, "r": r,
        "W1": planes(W1), "W1i": planes(W1i),
        "W2": planes(W2), "W2i": planes(W2i),
        "W2_raw": W2, "W2i_raw": W2i,
        "tb_raw": tb, "tbi_raw": tbi,
        "T": (T, T_s), "Ti": (Ti, Ti_s),
        "tb": (tb, tb_s), "tbi": (tbi, tbi_s),
        "urth": (urth, urth_s), "urth_i": (urth_i, urth_is),
        "q": qcol, "r32": r32, "r32s": r32s, "r16": r16, "r16s": r16s,
    }


def _dft_r(blocks, roots, roots_s, q, inverse: bool):
    """Elementwise DFT_r over a list of r [..., B]-blocks; roots [L-broadcastable]
    per (k3, j3) from the urth table. For r ≤ 2 this is pure add/sub."""
    r = len(blocks)
    if r == 1:
        return blocks
    if r == 2:
        s = blocks[0] + blocks[1]
        s = jnp.where(s >= q, s - q, s)
        d = jnp.where(blocks[0] >= blocks[1],
                      blocks[0] - blocks[1], blocks[0] + q - blocks[1])
        return [s, d]
    out = []
    for k3 in range(r):
        acc = None
        for j3 in range(r):
            term = mulmod_shoup(blocks[j3], roots[:, k3, j3][..., None, None],
                                roots_s[:, k3, j3][..., None, None], q)
            if acc is None:
                acc = term
            else:
                acc = _cond_sub(acc + term, q)
        out.append(acc)
    return out


@partial(jax.jit, static_argnums=(1, 2))
def ntt_mxu3(x, n: int, qs: tuple[int, ...]):
    """Forward negacyclic NTT, [..., L, n] natural order → 3-factor slot
    order (k1·Br + k3·B + k2)."""
    t = mxu3_tables(n, qs)
    A, B, r = t["A"], t["B"], t["r"]
    lead = x.shape[:-2]
    L = x.shape[-2]
    q = t["q"]
    # rows j1, lanes m = j3·B + j2  (contract j1 ⇒ move it last for _matmul_mod)
    xg = x.reshape(*lead, L, A, B * r)
    xg = jnp.swapaxes(xg, -1, -2)                 # [..., L, Br, A]
    y = _matmul_mod(xg, t["W1"], t)               # [..., L, Br, k1]
    y = jnp.swapaxes(y, -1, -2)                   # [..., L, k1, m]
    Tv, Ts = t["T"]
    y = mulmod_shoup(y, Tv, Ts, q)
    blocks = [y[..., k * B:(k + 1) * B] for k in range(r)]
    urth, urth_s = t["urth"]
    blocks = _dft_r(blocks, urth, urth_s, q, inverse=False)
    tbv, tbs = t["tb"]
    outs = []
    for k3 in range(r):
        b = blocks[k3]
        if k3 > 0:
            b = mulmod_shoup(b, tbv[:, k3][:, None, :], tbs[:, k3][:, None, :], q)
        # DFT_B over j2 (last axis): contract with W2
        z = _matmul_mod(b, t["W2"], t)            # [..., L, k1, k2]
        outs.append(z)
    return jnp.concatenate(outs, axis=-1).reshape(*lead, L, n) if r > 1 else \
        outs[0].reshape(*lead, L, n)


@partial(jax.jit, static_argnums=(1, 2))
def intt_mxu3(x, n: int, qs: tuple[int, ...]):
    """Inverse of ntt_mxu3 (3-factor slot order in, natural order out)."""
    t = mxu3_tables(n, qs)
    A, B, r = t["A"], t["B"], t["r"]
    lead = x.shape[:-2]
    L = x.shape[-2]
    q = t["q"]
    xg = x.reshape(*lead, L, A, B * r)
    blocks = [xg[..., k * B:(k + 1) * B] for k in range(r)]
    # undo stage 3: inverse DFT_B (unnormalized W2i; 1/n sits in W1i)
    blocks = [_matmul_mod(b, t["W2i"], t) for b in blocks]
    # undo the small twiddle on k3 ≥ 1
    tbv, tbs = t["tbi"]
    blocks = [
        b if k3 == 0 else
        mulmod_shoup(b, tbv[:, k3][:, None, :], tbs[:, k3][:, None, :], q)
        for k3, b in enumerate(blocks)
    ]
    # undo the DFT_r (inverse roots, unnormalized)
    urth_i, urth_is = t["urth_i"]
    blocks = _dft_r(blocks, urth_i, urth_is, q, inverse=True)
    y = jnp.concatenate(blocks, axis=-1) if r > 1 else blocks[0]
    Tv, Ts = t["Ti"]
    y = mulmod_shoup(y, Tv, Ts, q)
    y = jnp.swapaxes(y, -1, -2)                   # [..., L, m, k1]
    z = _matmul_mod(y, t["W1i"], t)               # [..., L, m, j1]
    return jnp.swapaxes(z, -1, -2).reshape(*lead, L, n)


@partial(jax.jit, static_argnums=(1, 2))
def ntt_mxu3_bcast(x, n: int, qs: tuple[int, ...]):
    """Forward 3-factor NTT of each digit row of x [..., D, n] under EVERY
    limb's tables at once → [..., D, L, n] (unreduced inputs welcome; see
    ntt_mxu.ntt_mxu_bcast)."""
    t = mxu3_tables(n, qs)
    A, B, r = t["A"], t["B"], t["r"]
    lead = x.shape[:-1]
    L = len(qs)
    q = t["q"]
    xg = jnp.swapaxes(x.reshape(*lead, A, B * r), -1, -2)   # [..., D, Br, A]
    y = _matmul_mod_bcast(xg, t["W1"], t)                   # [..., D, L, Br, k1]
    y = jnp.swapaxes(y, -1, -2)                             # [..., D, L, k1, m]
    Tv, Ts = t["T"]
    y = mulmod_shoup(y, Tv, Ts, q)
    blocks = [y[..., k * B:(k + 1) * B] for k in range(r)]
    urth, urth_s = t["urth"]
    blocks = _dft_r(blocks, urth, urth_s, q, inverse=False)
    tbv, tbs = t["tb"]
    outs = []
    for k3 in range(r):
        b = blocks[k3]
        if k3 > 0:
            b = mulmod_shoup(b, tbv[:, k3][:, None, :], tbs[:, k3][:, None, :], q)
        outs.append(_matmul_mod(b, t["W2"], t))
    z = jnp.concatenate(outs, axis=-1) if r > 1 else outs[0]
    return z.reshape(*lead, L, n)
