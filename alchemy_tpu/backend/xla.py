"""XLA backend: exact mod-q arithmetic on uint32 lanes (jnp; CPU and GPU).

Every product is built from 32-bit lane operations, with no 64-bit integer
type and no mulhi (DESIGN.md):
- full 32×32→64 products via 16-bit splits with explicit carries;
- constant multiplication (transform matrices, twiddles, per-limb scalars)
  via Shoup precomputation: r = lo(a·w) − lo(mulhi(a, ⌊w·2^32/q⌋)·q), one
  conditional subtract — exact for any q < 2^31 and any a < 2^32;
- variable×variable products reduce hi·2^32+lo with Shoup multiplies by the
  constants 2^32 mod q and 2^16 mod q (requires q > 2^16).

Every op is elementwise/jnp-native and jit-safe; per-modulus constants are
Python ints baked into the trace. Bit-identical to backend/golden.py
(tests/test_xla_backend.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)

#: when set to a list, axis_matmul appends (L, d_in, d_out, R) per group
#: application at trace time — the exact-MAC ledger used by
#: scripts/profile_examples.py (None = off, zero overhead)
MAC_COUNTER: list | None = None


def _split(a):
    return a & _MASK16, a >> np.uint32(16)


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays."""
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = p01 + p10
    carry_mid = (mid < p01).astype(U32)  # wrapped?
    lo = p00 + (mid << np.uint32(16))
    carry_lo = (lo < p00).astype(U32)
    return a1 * b1 + (mid >> np.uint32(16)) + (carry_mid << np.uint32(16)) + carry_lo


def mul_u32_hilo(a, b):
    a0, a1 = _split(a)
    b0, b1 = _split(b)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = p01 + p10
    carry_mid = (mid < p01).astype(U32)
    lo = p00 + (mid << np.uint32(16))
    carry_lo = (lo < p00).astype(U32)
    hi = a1 * b1 + (mid >> np.uint32(16)) + (carry_mid << np.uint32(16)) + carry_lo
    return hi, lo


def _cond_sub(r, q):
    return jnp.where(r >= q, r - q, r)


def shoup_const(w: int, q: int) -> int:
    """⌊w·2^32/q⌋ as a uint32 constant (requires w < q)."""
    return (int(w) << 32) // int(q)


def mulmod_shoup(a, w, ws, q):
    """a·w mod q for constant w with Shoup companion ws; exact for any
    uint32 a. All of w, ws, q may be arrays broadcastable against a."""
    hi = mulhi_u32(a, ws)
    r = a * w - hi * q
    return _cond_sub(r, q)


@lru_cache(maxsize=None)
def _qconsts(qs: tuple[int, ...]):
    """Per-limb constant arrays, shaped [L, 1] for broadcasting."""
    def col(vals):
        # host numpy constants (jit-trace-safe to cache)
        return np.array(vals, dtype=np.uint32)[:, None]

    r2 = [(1 << 32) % q for q in qs]
    r16 = [(1 << 16) % q for q in qs]
    return {
        "q": col(qs),
        "r2": col(r2),
        "r2s": col([shoup_const(w, q) for w, q in zip(r2, qs)]),
        "r16": col(r16),
        "r16s": col([shoup_const(w, q) for w, q in zip(r16, qs)]),
    }


@jax.jit
def _mulmod_arrays(a, b, q, r2, r2s, r16, r16s):
    hi, lo = mul_u32_hilo(a, b)
    t1 = mulmod_shoup(hi, r2, r2s, q)  # hi·2^32 mod q
    ll, lh = _split(lo)  # _split returns (low16, high16)
    t2 = _cond_sub(mulmod_shoup(lh, r16, r16s, q) + ll, q)
    return _cond_sub(t1 + t2, q)


def mulmod(a, b, qs: tuple[int, ...]):
    """General a·b mod q (per-limb moduli), a,b in [0, q) with q < 2^31."""
    c = _qconsts(qs)
    return _mulmod_arrays(a, b, c["q"], c["r2"], c["r2s"], c["r16"], c["r16s"])


@jax.jit
def _add_mod(a, b, q):
    return _cond_sub(a + b, q)


@jax.jit
def _sub_mod(a, b, q):
    return jnp.where(a >= b, a - b, a + q - b)


@jax.jit
def _neg_mod(a, q):
    return jnp.where(a == 0, a, q - a)


@jax.jit
def _mulmod_shoup_jit(a, w, ws, q):
    return mulmod_shoup(a, w, ws, q)


@jax.jit
def _axis_apply(xm, W, WS, q4):
    """One per-axis transform step: xm [L, d_in, R] × W [L, d_out, d_in].
    Elementwise path: Shoup products materialized then mod-tree-summed."""
    prod = mulmod_shoup(xm[:, None, :, :], W[:, :, :, None], WS[:, :, :, None], q4)
    return _modsum(prod, axis=2, q=q4)  # [L, d_out, R]


@jax.jit
def _axis_apply_mxu(xm, Wp, q, r16, r16s, r32, r32s):
    """Matmul path: digit-plane bf16 einsums (exact for d_in ≤ 256; see
    backend/ntt_mxu.py) — contracts on the tensor cores without
    materializing the [d_out, d_in, R] product tensor.

    xm [L, d_in, R] u32; Wp [L, 4, 4, d_out, d_in] scaled bf16 planes
    (V_{d,f} of 2^(8d)·W mod q — ntt_mxu.scaled_planes); consts [L,1,1].

    Bit-identical canonical outputs: adjacent input planes PAIR along the
    contraction when d_in ≤ 128 (8 einsums of 2K, exact since
    255·255·2K < 2^24), and for q < 2^30 the plane sums assemble
    BYTE-SERIALLY into value = w0 + 2^16·m (the scaled weights' top byte
    < 64 bounds every intermediate; ntt_mxu._recombine_planes derives the
    bound) so one Shoup multiply + a conditional subtract replace the
    carry-chain + reduce + Shoup + cond-sub recombination."""
    K = xm.shape[1]
    fast = isinstance(q, np.ndarray) and bool((q < (1 << 30)).all()) \
        and K <= 256
    xp = [
        ((xm >> np.uint32(8 * d)) & np.uint32(0xFF)).astype(jnp.bfloat16)
        for d in range(4)
    ]
    sums = [None] * 4
    if K <= 128:
        xpairs = [jnp.concatenate([xp[0], xp[1]], axis=1),
                  jnp.concatenate([xp[2], xp[3]], axis=1)]
        for pi, (d0, d1) in enumerate(((0, 1), (2, 3))):
            for f in range(4):
                # jnp concat: Wp is host numpy at trace time but a device
                # array on the eager path — never force a host readback
                Wcat = jnp.concatenate([Wp[:, d0, f], Wp[:, d1, f]], axis=-1)
                prod = jnp.einsum(
                    "lkr,lak->lar", xpairs[pi], Wcat,
                    preferred_element_type=jnp.float32,
                ).astype(jnp.uint32)
                sums[f] = prod if sums[f] is None else sums[f] + prod
    else:
        for d in range(4):
            for f in range(4):
                prod = jnp.einsum(
                    "lkr,lak->lar", xp[d], Wp[:, d, f],
                    preferred_element_type=jnp.float32,
                ).astype(jnp.uint32)
                sums[f] = prod if sums[f] is None else sums[f] + prod
    if fast:
        s0, s1, s2, s3 = sums
        b0 = s0 & np.uint32(0xFF)
        u = (s0 >> np.uint32(8)) + s1
        b1 = u & np.uint32(0xFF)
        v = (u >> np.uint32(8)) + s2
        b2 = v & np.uint32(0xFF)
        w = (v >> np.uint32(8)) + s3        # < 2^24 (K ≤ 256, q < 2^30)
        w0 = b0 + (b1 << np.uint32(8))      # value = w0 + 2^16·m
        m = b2 + (w << np.uint32(8))
        # mulmod_shoup canonicalizes, so out < q + 2^16: one cond-sub
        out = mulmod_shoup(m, r16, r16s, q) + w0
        return _cond_sub(out, q)
    lo = sums[0]
    hi = jnp.zeros_like(lo)
    for f in (1, 2, 3):
        add_lo = sums[f] << np.uint32(8 * f)
        lo = lo + add_lo
        carry = (lo < add_lo).astype(jnp.uint32)
        hi = hi + (sums[f] >> np.uint32(32 - 8 * f)) + carry
    ll, lh = _split(lo)
    lored = _cond_sub(mulmod_shoup(lh, r16, r16s, q) + ll, q)
    hired = mulmod_shoup(hi, r32, r32s, q)  # hi < 2^19
    return _cond_sub(hired + lored, q)


class XlaBackend:
    name = "xla"

    def __init__(self):
        self._mat_cache: dict = {}
        self._mat_dev_cache: dict = {}
        self._kron_cache: dict = {}

    # -- construction -------------------------------------------------------

    def asarray(self, arr: np.ndarray, qs: tuple[int, ...]):
        a = np.asarray(arr, dtype=np.int64)
        if a.ndim == 1:
            a = np.broadcast_to(a[None, :], (len(qs), a.shape[0]))
        a = a % np.asarray(qs, dtype=np.int64)[:, None]
        return jnp.asarray(a.astype(np.uint32))

    def to_numpy(self, a) -> np.ndarray:
        return np.asarray(a).astype(np.int64)

    def zeros(self, nlimb: int, n: int):
        return jnp.zeros((nlimb, n), dtype=U32)

    # -- elementwise --------------------------------------------------------

    def add(self, a, b, qs):
        return _add_mod(a, b, _qconsts(qs)["q"])

    def sub(self, a, b, qs):
        return _sub_mod(a, b, _qconsts(qs)["q"])

    def neg(self, a, qs):
        return _neg_mod(a, _qconsts(qs)["q"])

    def mul(self, a, b, qs):
        return mulmod(a, b, qs)

    def mul_const(self, a, consts, qs):
        w = np.array([int(c) % q for c, q in zip(consts, qs)], dtype=np.uint32)[:, None]
        ws = np.array(
            [shoup_const(int(c) % q, q) for c, q in zip(consts, qs)], dtype=np.uint32
        )[:, None]
        return _mulmod_shoup_jit(a, jnp.asarray(w), jnp.asarray(ws), _qconsts(qs)["q"])

    def sum_terms(self, terms, qs):
        acc = terms[0]
        for t in terms[1:]:
            acc = self.add(acc, t, qs)
        return acc

    # -- per-axis transforms ------------------------------------------------

    def _mats_device(self, mat, per_limb: bool, qs: tuple[int, ...], traced: bool):
        """Stack per-limb matrices to [L, d_out, d_in] u32 with Shoup
        companions and bf16 digit planes, cached by content.

        Two-tier cache: host numpy always (safe to reuse inside jit traces,
        where they embed as constants); device arrays only for eager use
        (device arrays created inside a trace would leak tracers)."""
        mats = list(mat) if per_limb else [mat] * len(qs)
        key = (qs, tuple(m.tobytes() for m in mats), mats[0].shape)
        host = self._mat_cache.get(key)
        if host is None:
            ws, wss = [], []
            for m, q in zip(mats, qs):
                mm = np.asarray(m, dtype=np.int64) % q
                ws.append(mm.astype(np.uint32))
                ss = (mm.astype(object) << 32) // q
                wss.append(np.array(ss, dtype=np.uint32))
            W = np.stack(ws)
            import ml_dtypes

            from alchemy_tpu.backend.ntt_mxu import scaled_planes

            planes = np.stack(
                [scaled_planes(W[li], qs[li]) for li in range(len(qs))]
            ).astype(ml_dtypes.bfloat16)  # [L, 4, 4, d_out, d_in]
            host = (W, np.stack(wss), planes)
            self._mat_cache[key] = host
        if traced:
            return host
        dev = self._mat_dev_cache.get(key)
        if dev is None:
            dev = tuple(jnp.asarray(h) for h in host)
            self._mat_dev_cache[key] = dev
        return dev

    @staticmethod
    def _use_mxu() -> bool:
        return jax.default_backend() != "cpu"

    #: combined-axis cap for the Kronecker merge (≤ 256 keeps the bf16
    #: digit-plane einsum exact; 128 keeps the merged matrices small)
    _KRON_LIMIT = 128

    def _merge_axis_mats(self, mats, shape, qs: tuple[int, ...]):
        """Greedy Kronecker merge of ADJACENT transform axes while the
        combined dimensions stay ≤ _KRON_LIMIT.

        The H-tower rings factor into many tiny axes (φ-dims 2..64); one
        per-axis contraction costs ~16 small device dispatches, and the
        profiled HomomRLWR step was 73% reshape/copy launch overhead
        (VERDICT r3 #5). Merging adjacent axes halves-or-better the step
        count with bit-identical results: kron(W1, W2) applied to the
        flattened (ax, ax+1) index computes the same exact mod-q values.

        Returns [(n_axes_spanned, merged_mat_or_None, d_in, d_out)]."""
        groups = []
        i = 0

        def din(m):
            return (m[0] if isinstance(m, (list, tuple)) else m).shape[1]

        def dout(m):
            return (m[0] if isinstance(m, (list, tuple)) else m).shape[0]

        while i < len(mats):
            if mats[i] is None:
                groups.append((1, None, shape[i], shape[i]))
                i += 1
                continue
            cur = mats[i]
            si, so = din(cur), dout(cur)
            span = 1
            while (i + span < len(mats) and mats[i + span] is not None
                   and si * din(mats[i + span]) <= self._KRON_LIMIT
                   and so * dout(mats[i + span]) <= self._KRON_LIMIT):
                nxt = mats[i + span]
                cur = self._kron_pair(cur, nxt, qs)
                si *= din(nxt)
                so *= dout(nxt)
                span += 1
            groups.append((span, cur, si, so))
            i += span
        return groups

    def _kron_pair(self, m1, m2, qs: tuple[int, ...]):
        """Per-limb (or shared) Kronecker product, reduced mod q, cached.

        The cache keys on CONTENT (shape + bytes, like _mats_device), not
        array ids: to_pow/to_crt rebuild the per-limb lists every call, and
        content keys keep hits independent of whether a caller passes
        lru-cached (stable) or freshly built matrices. Distinct (axis-pair,
        qs) combinations are bounded by the ring factorizations in use, so
        the cache cannot grow without bound."""

        def mat_key(m):
            if isinstance(m, (list, tuple)):
                return tuple((x.shape, x.tobytes()) for x in m)
            return (m.shape, m.tobytes())

        key = (mat_key(m1), mat_key(m2), qs)
        out = self._kron_cache.get(key)
        if out is None:
            p1 = isinstance(m1, (list, tuple))
            p2 = isinstance(m2, (list, tuple))
            if p1 or p2:
                l1 = list(m1) if p1 else [m1] * len(qs)
                l2 = list(m2) if p2 else [m2] * len(qs)
                out = [
                    np.kron(a.astype(np.int64) % q, b.astype(np.int64) % q) % q
                    for a, b, q in zip(l1, l2, qs)
                ]
            else:
                out = np.kron(m1.astype(np.int64), m2.astype(np.int64))
            self._kron_cache[key] = out
        return out

    def axis_matmul(self, a, mats, shape, qs):
        L = a.shape[0]
        c = _qconsts(qs)
        q4 = c["q"].reshape(L, 1, 1, 1)
        q3 = c["q"].reshape(L, 1, 1)
        r16_3 = c["r16"].reshape(L, 1, 1)
        r16s_3 = c["r16s"].reshape(L, 1, 1)
        r32_3 = c["r2"].reshape(L, 1, 1)
        r32s_3 = c["r2s"].reshape(L, 1, 1)
        mxu = self._use_mxu()
        groups = self._merge_axis_mats(list(mats), list(shape), qs)
        dims = []
        pos = 0
        for (span, _mat, d_in, _d_out) in groups:
            size = 1
            for s in shape[pos:pos + span]:
                size *= s
            dims.append(size)
            pos += span
        x = a.reshape(L, *dims)
        for gi, (span, mat, d_in, d_out) in enumerate(groups):
            if mat is None:
                continue
            per_limb = isinstance(mat, (list, tuple))
            traced = isinstance(a, jax.core.Tracer)
            W, WS, Wp = self._mats_device(mat, per_limb, qs, traced)
            xm = jnp.moveaxis(x, 1 + gi, 1)  # [L, d_in, *rest]
            rest_shape = xm.shape[2:]
            xm = xm.reshape(L, d_in, -1)
            if MAC_COUNTER is not None:
                # exact base-MAC ledger for the profiling harness
                # (scripts/profile_examples.py): L·d_out·d_in·R base MACs
                # per group application; the digit-plane matmul path issues 16
                # bf16 dots of this base count
                MAC_COUNTER.append((L, d_in, d_out, int(xm.shape[-1])))
            if mxu and d_in <= 256:
                res = _axis_apply_mxu(xm, Wp, q3, r16_3, r16s_3, r32_3, r32s_3)
            else:
                res = _axis_apply(xm, W, WS, q4)  # [L, d_out, R]
            res = res.reshape(L, d_out, *rest_shape)
            x = jnp.moveaxis(res, 1, 1 + gi)
            dims[gi] = d_out
        return x.reshape(L, -1)

    # -- signed helpers ------------------------------------------------------

    def lift_centered(self, a, qs):
        arr = self.to_numpy(a)
        q = np.asarray(qs, dtype=np.int64)[:, None]
        return np.where(arr > q // 2, arr - q, arr)

    def reduce_signed(self, a_signed, qs):
        return self.asarray(np.asarray(a_signed, dtype=np.int64), qs)

    def broadcast_row(self, row, nlimb, qs):
        r = np.asarray(row, dtype=np.int64)
        return self.asarray(np.broadcast_to(r[None, :], (nlimb, r.shape[0])), qs)

    # -- composite device ops (bit-identical to backend/golden.py) ----------

    def stack_rows(self, rows):
        return jnp.stack(rows)

    def rescale_step(self, data, qs, zp):
        return _xla_rescale_step(data, tuple(qs), int(zp))

    def modswitch_up(self, data, old_qs, new_qs):
        old_qs, new_qs = tuple(old_qs), tuple(new_qs)
        d = 1
        for q in new_qs[len(old_qs):]:
            d *= q
        rows = []
        for i, q in enumerate(old_qs):
            w = np.uint32(d % q)
            rows.append(mulmod_shoup(data[i], w, np.uint32(shoup_const(d % q, q)), np.uint32(q)))
        zero = jnp.zeros_like(data[0])
        rows += [zero for _ in new_qs[len(old_qs):]]
        return jnp.stack(rows)

    def hybrid_digit_rows(self, data, qs, groups, ext_qs):
        """[dnum, T, n] hybrid digit rows (group-Garner lift + extension);
        bit-identical to backend/golden.py hybrid_digit_rows — both compute
        the exact mixed-radix digits of V_j < Q_j (she/hybrid.py dataflow,
        jit-traceable)."""
        from alchemy_tpu.she.hybrid import extend_digits, garner_digits

        ext_qs = tuple(ext_qs)
        out = []
        off = 0
        for grp in groups:
            grp = tuple(grp)
            cnt = len(grp)
            # garner_digits expects [..., k, :] residue rows mod grp[k]
            xs = garner_digits(jnp.stack(
                [data[off + k] for k in range(cnt)], axis=-2), grp)
            out.append(extend_digits(xs, grp, ext_qs))
            off += cnt
        return jnp.stack(out)

    def gadget_digit_rows(self, data, qs, base):
        qs = tuple(qs)
        L = len(qs)
        out = []
        for i, qi in enumerate(qs):
            row = data[i][None, :]
            if base is None:
                out.append(_reduce_u32_any(jnp.broadcast_to(row, data.shape), qs))
            else:
                nd = 0
                v = qi - 1
                while v:
                    nd += 1
                    v //= base
                for k in range(nd):
                    dig = (row // np.uint32(base**k)) % np.uint32(base)
                    out.append(
                        _reduce_u32_any(jnp.broadcast_to(dig, data.shape), qs)
                    )
        return jnp.stack(out)


def _modsum(prod, axis: int, q):
    """Tree-sum mod q along `axis` (pads to a power of two)."""
    n = prod.shape[axis]
    # pad to next power of two with zeros
    pow2 = 1
    while pow2 < n:
        pow2 *= 2
    if pow2 != n:
        pad = [(0, 0)] * prod.ndim
        pad[axis] = (0, pow2 - n)
        prod = jnp.pad(prod, pad)
    while prod.shape[axis] > 1:
        half = prod.shape[axis] // 2
        a = jnp.take(prod, jnp.arange(0, half), axis=axis)
        b = jnp.take(prod, jnp.arange(half, 2 * half), axis=axis)
        s = a + b
        prod = jnp.where(s >= q, s - q, s)
    return jnp.squeeze(prod, axis=axis)


def _reduce_u32_any(v, qs: tuple[int, ...]):
    """v mod q for arbitrary uint32 v with per-limb q (q > 2^16)."""
    c = _qconsts(qs)
    ll, lh = _split(v)
    return _cond_sub(mulmod_shoup(lh, c["r16"], c["r16s"], c["q"]) + ll, c["q"])


def _xla_rescale_step(data, qs: tuple[int, ...], zp: int):
    qk = qs[-1]
    new_qs = qs[:-1]
    r = data[-1]
    half = np.uint32(qk // 2)
    is_neg = r > half
    pz = np.uint32(zp)
    r_mod_p = r % pz
    qk_mod_p = np.uint32(qk % zp)
    rc_mod_p = jnp.where(is_neg, (r_mod_p + pz - qk_mod_p) % pz, r_mod_p)
    inv_qk_p = np.uint32(pow(qk, -1, zp))
    t = (((pz - rc_mod_p) % pz) * inv_qk_p) % pz
    t_neg = t > pz // np.uint32(2)
    rows = []
    for j, qj in enumerate(new_qs):
        qj32 = np.uint32(qj)
        r16 = np.uint32((1 << 16) % qj)
        r16s = np.uint32(shoup_const((1 << 16) % qj, qj))
        ll, lh = _split(r)
        r_red = _cond_sub(mulmod_shoup(lh, r16, r16s, qj32) + ll, qj32)
        qk_mod = np.uint32(qk % qj)
        rc = jnp.where(
            is_neg,
            jnp.where(r_red >= qk_mod, r_red - qk_mod, r_red + qj32 - qk_mod),
            r_red,
        )
        tc = jnp.where(t_neg, qj32 - (pz - t), t)
        qkt = mulmod_shoup(tc, qk_mod, np.uint32(shoup_const(qk % qj, qj)), qj32)
        delta = _cond_sub(rc + qkt, qj32)
        cj = data[j]
        diff = jnp.where(cj >= delta, cj - delta, cj + qj32 - delta)
        inv_qk = pow(qk, -1, qj)
        rows.append(
            mulmod_shoup(diff, np.uint32(inv_qk), np.uint32(shoup_const(inv_qk, qj)), qj32)
        )
    return jnp.stack(rows)
