"""Matmul negacyclic NTT: 4-step factorization as exact bf16 matmuls.

The butterfly NTT (backend/ntt.py) is elementwise- and memory-bound. This
path computes NTT_n = (DFT_n1 ⊗ I)·twiddle·(I ⊗ DFT_n2) with the per-factor
DFTs as matrix multiplications on the tensor cores:

- 32-bit operands are split into four unsigned 8-bit digit planes;
- the matrix is pre-scaled per operand plane: V_d = 2^(8d)·W mod q is
  precomputed on the host and split into its own four 8-bit planes V_{d,f},
  so x·W = Σ_d x_d·(2^(8d)W) = Σ_f 2^(8f)·(Σ_d x_d @ V_{d,f});
- each plane pair is multiplied as bf16×bf16 → f32 (products of 8-bit
  values are exact in bf16/f32; row sums < 255·255·256 < 2^24 stay exact
  in f32 for contraction size up to 256);
- only FOUR plane sums S_f remain (vs seven diagonal sums in the naive
  scheme), and Σ_f S_f·2^(8f) < 2^51, so the whole value is accumulated
  exactly in a (lo, hi) uint32 pair and reduced mod q ONCE (one Shoup
  multiply by 2^32 mod q + one 16-bit-split reduction) — ~3× fewer
  elementwise ops per matmul stage than reducing each diagonal sum separately.

Output slot order is the (k1, k2) grid order (k = k1 + n1·k2 at position
k1·n2 + k2) — fixed and self-inverse; pointwise ct ops are order-agnostic
(DESIGN.md). Matrices are natural-order DFTs (no bit reversal).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from alchemy_tpu.backend.xla import _cond_sub, _split, mulmod_shoup, shoup_const
from alchemy_tpu.nt.primes import root_of_unity

MAX_FACTOR = 256  # contraction size bound keeping f32 sums < 2^24


def _pick_split(n: int) -> tuple[int, int]:
    """n = n1·n2 with both ≤ MAX_FACTOR, n1 as close to 128 as possible."""
    best = None
    n1 = 1
    while n1 <= n:
        n2 = n // n1
        if n1 * n2 == n and n1 <= MAX_FACTOR and n2 <= MAX_FACTOR:
            score = abs(n1 - 128)
            if best is None or score < best[0]:
                best = (score, n1, n2)
        n1 *= 2
    if best is None:
        raise ValueError(f"ring size {n} too large for the 2-level matmul NTT")
    return best[1], best[2]


def _digit_planes_const(M: np.ndarray) -> np.ndarray:
    """[4, rows, cols] bf16 digit planes of a u32 matrix (host)."""
    planes = np.stack([(M >> (8 * d)) & 0xFF for d in range(4)])
    return planes.astype(np.float32)  # cast to bf16 at use site


def scaled_planes(M: np.ndarray, q: int) -> np.ndarray:
    """[4, 4, rows, cols] digit planes of V_d = 2^(8d)·M mod q (host f32):
    axis 0 indexes the operand plane d, axis 1 the matrix plane f."""
    per_d = []
    for d in range(4):
        Vd = (np.asarray(M, dtype=np.int64) * pow(2, 8 * d, q)) % q
        per_d.append(_digit_planes_const(Vd.astype(np.uint32)))
    return np.stack(per_d)


@lru_cache(maxsize=None)
def mxu_tables(n: int, qs: tuple[int, ...]):
    """Host tables for the 4-step matmul NTT (cached numpy)."""
    n1, n2 = _pick_split(n)
    L = len(qs)
    W1 = np.empty((L, n1, n1), dtype=np.int64)    # DFT over j1 (root w^n2)
    W2 = np.empty((L, n2, n2), dtype=np.int64)    # DFT over j2 (root w^n1)
    W1i = np.empty((L, n1, n1), dtype=np.int64)
    W2i = np.empty((L, n2, n2), dtype=np.int64)
    tw = np.empty((L, n1, n2), dtype=np.uint32)   # w^(k1·j2)
    tw_s = np.empty((L, n1, n2), dtype=np.uint32)
    itw = np.empty((L, n1, n2), dtype=np.uint32)
    itw_s = np.empty((L, n1, n2), dtype=np.uint32)
    pre = np.empty((L, n), dtype=np.uint32)
    pre_s = np.empty((L, n), dtype=np.uint32)
    post = np.empty((L, n), dtype=np.uint32)      # ψ^{-j}·n^{-1}, in (j1,j2) grid
    post_s = np.empty((L, n), dtype=np.uint32)
    for li, q in enumerate(qs):
        psi = root_of_unity(2 * n, q)
        w = psi * psi % q
        w1 = pow(w, n2, q)
        w2 = pow(w, n1, q)
        w1i = pow(w1, -1, q)
        w2i = pow(w2, -1, q)
        n_inv = pow(n, -1, q)
        n_inv_full = pow(n, -1, q)
        psi_inv_ = pow(psi, -1, q)
        for a in range(n1):
            for b in range(n1):
                # forward W1 folds the psi^(j1*n2) part of the pre-twist
                W1[li, a, b] = pow(w1, a * b, q) * pow(psi, b * n2, q) % q
                # inverse W1i folds psi^(-j1*n2) (output rows) and 1/n
                W1i[li, a, b] = (
                    pow(w1i, a * b, q) * pow(psi_inv_, a * n2, q) * n_inv_full % q
                )
        for a in range(n2):
            for b in range(n2):
                W2[li, a, b] = pow(w2, a * b, q)
                W2i[li, a, b] = pow(w2i, a * b, q)
        for k1 in range(n1):
            for j2 in range(n2):
                # forward twiddle folds the psi^(j2) part of the pre-twist
                v = pow(w, k1 * j2, q) * pow(psi, j2, q) % q
                tw[li, k1, j2] = v
                tw_s[li, k1, j2] = (v << 32) // q
                # inverse twiddle folds psi^(-j2)
                u = pow(pow(w, k1 * j2, q), -1, q) * pow(psi_inv_, j2, q) % q
                itw[li, k1, j2] = u
                itw_s[li, k1, j2] = (u << 32) // q
        psi_inv = pow(psi, -1, q)
        for j1 in range(n1):
            for j2 in range(n2):
                j = j1 * n2 + j2
                pos = j1 * n2 + j2  # natural storage, (j1, j2) grid C-order
                v = pow(psi, j, q)
                pre[li, pos] = v
                pre_s[li, pos] = (v << 32) // q
                u = pow(psi_inv, j, q) * n_inv % q
                post[li, pos] = u
                post_s[li, pos] = (u << 32) // q

    def planes(M):
        # [L, 4, 4, rows, cols] scaled digit planes (f32 host; bf16 on device)
        return np.stack([scaled_planes(M[li], qs[li]) for li in range(len(qs))])

    qcol = np.array(qs, dtype=np.uint32)[:, None, None]
    r32 = np.array([(1 << 32) % q for q in qs], dtype=np.uint32)[:, None, None]
    r32s = np.array(
        [shoup_const((1 << 32) % q, q) for q in qs], dtype=np.uint32
    )[:, None, None]
    r16 = np.array([(1 << 16) % q for q in qs], dtype=np.uint32)[:, None, None]
    r16s = np.array(
        [shoup_const((1 << 16) % q, q) for q in qs], dtype=np.uint32
    )[:, None, None]
    return {
        "n1": n1,
        "n2": n2,
        "W1": planes(W1), "W2": planes(W2), "W1i": planes(W1i), "W2i": planes(W2i),
        "tw": (tw, tw_s), "itw": (itw, itw_s),
        "pre": (pre, pre_s), "post": (post, post_s),
        "q": qcol, "r32": r32, "r32s": r32s, "r16": r16, "r16s": r16s,
    }


def _digit_planes_runtime(x):
    """[..., 4-plane] bf16 digit planes of a u32 array (device)."""
    planes = [
        ((x >> np.uint32(8 * d)) & np.uint32(0xFF)).astype(jnp.bfloat16)
        for d in range(4)
    ]
    return planes


# ---------------------------------------------------------------------------
# int8 variant: one s8×s8→s32 einsum contracts ALL FOUR operand digit planes
# at once (merged contraction axis 4K ≤ 1024; |partial sums| < 2^26, exact in
# int32), replacing the 16 bf16 plane matmuls with a single 4-plane-output
# dot. Operands are re-centered to [-128, 127]; the affine correction
# S_f = dot_f + 128·bytesum(x)[r] + 128·Σ u_{d,f}[a,·] restores the unsigned
# value (the 128² cross terms cancel between the row and column corrections).
# Where int8 products run at twice the bf16 rate this roughly halves the
# matmul cost of every NTT stage.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def mxu_tables8(n: int, qs: tuple[int, ...]):
    """mxu_tables plus int8-packed matrix planes: for each DFT matrix, a pair
    (U8 [L, 4f, A, 4K] int8, cc [L, 4f, A] int32) with
    U8[l, f, a, d·K+k] = V_{d,f}[a,k] − 128 and cc = 128·Σ_{d,k} U8."""
    t = mxu_tables(n, qs)

    def pack(P):
        # P: [L, 4d, 4f, A, K] f32 holding byte values 0..255
        Pt = np.transpose(np.asarray(P, dtype=np.int64), (0, 2, 3, 1, 4))
        L, F, A, D, K = Pt.shape
        U = Pt.reshape(L, F, A, D * K) - 128
        cc = (128 * U.sum(-1)).astype(np.int32)
        return U.astype(np.int8), cc

    t8 = dict(t)
    for k in ("W1", "W2", "W1i", "W2i"):
        t8[k + "_8"] = pack(t[k])
    return t8


def _planes8_runtime(x):
    """x u32 [..., R, K] → (int8 planes [..., R, 4K] with index d·K+k,
    byte-sum Σ_{d,k} x_d [..., R] u32)."""
    K = x.shape[-1]
    xs = [(x >> np.uint32(8 * d)) & np.uint32(0xFF) for d in range(4)]
    bsum = jnp.sum(xs[0] + xs[1] + xs[2] + xs[3], axis=-1, dtype=jnp.uint32)
    x8 = jnp.stack(
        [(p.astype(jnp.int32) - 128).astype(jnp.int8) for p in xs], axis=-2
    ).reshape(*x.shape[:-1], 4 * K)
    return x8, bsum


def _recombine_planes(sums, t, K: int, fast_ok: bool = False):
    """Σ_f S_f·2^(8f) < 2^51 assembled exactly as (lo, hi) u32, one mod-q
    reduction (shared tail of _matmul_mod / the int8 variants). K is the
    contraction length of each operand plane behind the sums.

    fast_ok=True (the unsigned bf16-plane paths only, NOT int8) enables a
    byte-serial assembly when q < 2^30 and K ≤ 256; otherwise the exact
    compare/carry chain below runs. Bit-identical canonical outputs.

    Bound: the scaled weights 2^(8d)·W mod q are < 2^30, so their top byte
    planes are < 64; with 8-bit operand planes,
      s_f ≤ 4·K·255·255 = 66,585,600  (f ≤ 2),
      s_3 ≤ 4·K·255·63  = 16,450,560.
    Propagating each sum's high bits into the next byte lane,
      u = (s_0 >> 8) + s_1 ≤ 66,845,700,  v = (u >> 8) + s_2 ≤ 66,846,716,
      w = (v >> 8) + s_3 ≤ 261,120 + 16,450,560 = 16,711,680 < 2^24,
    so value = b_0 + 2^8·b_1 + 2^16·b_2 + 2^24·w = w0 + 2^16·m with
    w0 = b_0 + 2^8·b_1 < 2^16 and m = b_2 + 2^8·w < 2^32: no u32 overflow
    anywhere, no compare-carries. One Shoup multiply m·2^16 mod q plus one
    conditional subtract (2^16 < q) then canonicalizes w0 + 2^16·m."""
    q = t["q"]
    if (fast_ok and K <= MAX_FACTOR and isinstance(q, np.ndarray)
            and bool((q < (1 << 30)).all())):
        s0, s1, s2, s3 = sums
        b0 = s0 & np.uint32(0xFF)
        u = (s0 >> np.uint32(8)) + s1
        b1 = u & np.uint32(0xFF)
        v = (u >> np.uint32(8)) + s2
        b2 = v & np.uint32(0xFF)
        w = (v >> np.uint32(8)) + s3
        w0 = b0 + (b1 << np.uint32(8))
        m = b2 + (w << np.uint32(8))
        return _cond_sub(mulmod_shoup(m, t["r16"], t["r16s"], q) + w0, q)
    lo = sums[0]
    hi = jnp.zeros_like(lo)
    for f in (1, 2, 3):
        add_lo = sums[f] << np.uint32(8 * f)
        lo = lo + add_lo
        carry = (lo < add_lo).astype(jnp.uint32)
        hi = hi + (sums[f] >> np.uint32(32 - 8 * f)) + carry
    lored = _reduce_u32g(lo, t["q"], t["r16"], t["r16s"])
    hired = mulmod_shoup(hi, t["r32"], t["r32s"], t["q"])
    return _cond_sub(hired + lored, t["q"])


def _matmul_mod8(x, W8, t):
    """int8 modular matmul: x [..., L, R, K] u32 × (U8, cc) packed planes →
    [..., L, R, K_out] u32 mod q. One s8 einsum over the merged (d, k) axis;
    exact: |dot| ≤ 128²·4K = 2^26 < 2^31."""
    U8, cc = W8
    x8, bsum = _planes8_runtime(x)
    dot = jnp.einsum(
        "...lrk,lfak->...lfra", x8, U8, preferred_element_type=jnp.int32
    )
    corr = (bsum.astype(jnp.int32) << 7)[..., None, :, None]  # [..., L, 1, R, 1]
    ccb = jnp.asarray(cc)[:, :, None, :]                      # [L, 4f, 1, A]
    S = (dot + corr + ccb).astype(jnp.uint32)                 # [..., L, 4f, R, A]
    sums = [S[..., f, :, :] for f in range(4)]
    return _recombine_planes(sums, t, x.shape[-1])


def _matmul_mod8_bcast(x, W8, t):
    """Stage-1 int8 matmul of the broadcast NTT: x [..., D, R, K] u32 shared
    across limbs × packed planes → [..., D, L, R, K_out] u32."""
    U8, cc = W8
    x8, bsum = _planes8_runtime(x)
    dot = jnp.einsum(
        "...drk,lfak->...dlfra", x8, U8, preferred_element_type=jnp.int32
    )
    corr = (bsum.astype(jnp.int32) << 7)[..., :, None, None, :, None]
    ccb = jnp.asarray(cc)[:, :, None, :]
    S = (dot + corr + ccb).astype(jnp.uint32)
    sums = [S[..., f, :, :] for f in range(4)]
    return _recombine_planes(sums, t, x.shape[-1])


def _reduce_u32g(v, q, r16, r16s):
    ll, lh = _split(v)
    return _cond_sub(mulmod_shoup(lh, r16, r16s, q) + ll, q)


def _matmul_mod(x, Wp, t):
    """Modular matmul on the tensor cores: x [..., L, R, K] u32 × scaled planes
    Wp [L, 4, 4, K_out, K] (V_{d,f} of V_d = 2^(8d)·W mod q; DFT matrix
    applied as out[r, a] = Σ_b W[a, b]·x[r, b]).

    Returns [..., L, R, K_out] u32 mod q. Each bf16 matmul result is exact
    in f32 (row sums < 2^24 for K ≤ 256); the four plane sums S_f < 2^26
    are accumulated in u32, then Σ_f S_f·2^(8f) < 2^51 is assembled as an
    exact (lo, hi) uint32 pair and reduced mod q once."""
    q, r16, r16s = t["q"], t["r16"], t["r16s"]
    xp = _digit_planes_runtime(x)
    Wb = Wp.astype(jnp.bfloat16)
    sums = [None] * 4
    if x.shape[-1] <= 128:
        # pair adjacent operand planes along the contraction: 8 einsums of
        # 2K instead of 16 of K, exact (255·255·2K < 2^24) and
        # bit-identical (the paired dot equals the u32 sum of the two)
        xpairs = [jnp.concatenate([xp[0], xp[1]], axis=-1),
                  jnp.concatenate([xp[2], xp[3]], axis=-1)]
        for pi, (d0, d1) in enumerate(((0, 1), (2, 3))):
            for f in range(4):
                Wcat = jnp.concatenate([Wb[:, d0, f], Wb[:, d1, f]], axis=-1)
                prod = jnp.einsum(
                    "...lrk,lak->...lra", xpairs[pi], Wcat,
                    preferred_element_type=jnp.float32,
                ).astype(jnp.uint32)
                sums[f] = prod if sums[f] is None else sums[f] + prod
        return _recombine_planes(sums, t, x.shape[-1], fast_ok=True)
    for d in range(4):
        for f in range(4):
            # einsum over K: [..., L, R, K] × [L, K_out, K] → [..., L, R, K_out]
            prod = jnp.einsum(
                "...lrk,lak->...lra", xp[d], Wb[:, d, f],
                preferred_element_type=jnp.float32,
            ).astype(jnp.uint32)
            sums[f] = prod if sums[f] is None else sums[f] + prod
    # V = Σ_f S_f·2^(8f) < 2^51: exact 64-bit accumulation in (lo, hi)
    return _recombine_planes(sums, t, x.shape[-1], fast_ok=True)


def _mm(x, key, t, i8: bool):
    return _matmul_mod8(x, t[key + "_8"], t) if i8 else _matmul_mod(x, t[key], t)


@partial(jax.jit, static_argnums=(1, 2, 3))
def ntt_mxu(x, n: int, qs: tuple[int, ...], i8: bool = False):
    """Forward negacyclic NTT via digit-plane matmuls; x [..., L, n] natural order in,
    (k1, k2) grid order out. The psi pre-twist is folded into W1/tw.
    i8=True uses the int8 merged-plane matmuls (same values)."""
    t = mxu_tables8(n, qs) if i8 else mxu_tables(n, qs)
    n1, n2 = t["n1"], t["n2"]
    lead = x.shape[:-2]
    L = x.shape[-2]
    x = x.reshape(*lead, L, n1, n2)
    # DFT over j1: treat j2 as the row axis R → transpose to [..., L, n2, n1]
    x = jnp.swapaxes(x, -1, -2)
    y = _mm(x, "W1", t, i8)                 # [..., L, n2, n1] → k1
    y = jnp.swapaxes(y, -1, -2)                    # [..., L, k1, j2]
    twv, tws = t["tw"]
    y = mulmod_shoup(y, twv, tws, t["q"])
    z = _mm(y, "W2", t, i8)                 # over j2 → k2: [..., L, k1, k2]
    return z.reshape(*lead, L, n)


def _matmul_mod_bcast(x, Wp, t):
    """Stage-1 matmul of the broadcast NTT: x [..., D, R, K] u32 (shared
    across limbs) × scaled planes Wp [L, 4, 4, K_out, K] → [..., D, L, R,
    K_out] u32. Same recombination as _matmul_mod; the operand digit planes
    are extracted from the L-fold-smaller un-broadcast input."""
    q, r16, r16s = t["q"], t["r16"], t["r16s"]
    xp = _digit_planes_runtime(x)
    Wb = Wp.astype(jnp.bfloat16)
    sums = [None] * 4
    for d in range(4):
        for f in range(4):
            prod = jnp.einsum(
                "...drk,lak->...dlra", xp[d], Wb[:, d, f],
                preferred_element_type=jnp.float32,
            ).astype(jnp.uint32)
            sums[f] = prod if sums[f] is None else sums[f] + prod
    return _recombine_planes(sums, t, x.shape[-1], fast_ok=True)


@partial(jax.jit, static_argnums=(1, 2, 3))
def ntt_mxu_bcast(x, n: int, qs: tuple[int, ...], i8: bool = False):
    """Forward NTT of each row of x [..., D, n] under EVERY limb's tables at
    once: returns [..., D, L, n]. Equivalent to ntt_mxu over the materialized
    broadcast_to(x[..., None, :], (..., D, L, n)) but stage 1 contracts the
    un-broadcast input directly (the gadget-digit fan-out of the
    relinearization hot path: the digit rows are identical across target
    limbs, so materializing — and re-reading — the [D, L, n] fan-out through
    stage 1 is pure HBM waste)."""
    t = mxu_tables8(n, qs) if i8 else mxu_tables(n, qs)
    n1, n2 = t["n1"], t["n2"]
    lead = x.shape[:-1]
    L = len(qs)
    xg = jnp.swapaxes(x.reshape(*lead, n1, n2), -1, -2)  # [..., D, n2, n1]
    if i8:
        y = _matmul_mod8_bcast(xg, t["W1_8"], t)       # [..., D, L, n2, k1]
    else:
        y = _matmul_mod_bcast(xg, t["W1"], t)
    y = jnp.swapaxes(y, -1, -2)                        # [..., D, L, k1, j2]
    twv, tws = t["tw"]
    y = mulmod_shoup(y, twv, tws, t["q"])
    z = _mm(y, "W2", t, i8)                            # [..., D, L, k1, k2]
    return z.reshape(*lead, L, n)


@partial(jax.jit, static_argnums=(1, 2, 3))
def intt_mxu(x, n: int, qs: tuple[int, ...], i8: bool = False):
    """Inverse of ntt_mxu ((k1,k2) grid in, natural order out)."""
    t = mxu_tables8(n, qs) if i8 else mxu_tables(n, qs)
    n1, n2 = t["n1"], t["n2"]
    lead = x.shape[:-2]
    L = x.shape[-2]
    x = x.reshape(*lead, L, n1, n2)
    z = _mm(x, "W2i", t, i8)                 # inverse over k2 → j2
    itwv, itws = t["itw"]
    z = mulmod_shoup(z, itwv, itws, t["q"])
    z = jnp.swapaxes(z, -1, -2)                    # [..., L, j2, k1]
    y = _mm(z, "W1i", t, i8)                 # inverse over k1 → j1 (1/n and
    return jnp.swapaxes(y, -1, -2).reshape(*lead, L, n)  # psi^-j folded in)
