"""Exact numpy int64 backend — the golden model.

All residues are stored in [0, q) as int64; every product is reduced mod q
before accumulation so nothing exceeds 2^62. This backend is the bit-exact
oracle for the accelerator backends (SURVEY.md §4 test plan (a)-(b)).
"""

from __future__ import annotations

import numpy as np


class GoldenBackend:
    name = "golden"

    # -- construction -------------------------------------------------------

    def asarray(self, arr: np.ndarray, qs: tuple[int, ...]) -> np.ndarray:
        a = np.asarray(arr, dtype=np.int64)
        if a.ndim == 1:
            a = np.broadcast_to(a[None, :], (len(qs), a.shape[0])).copy()
        out = a % np.asarray(qs, dtype=np.int64)[:, None]
        return out

    def to_numpy(self, a: np.ndarray) -> np.ndarray:
        return np.asarray(a, dtype=np.int64)

    def zeros(self, nlimb: int, n: int) -> np.ndarray:
        return np.zeros((nlimb, n), dtype=np.int64)

    # -- elementwise mod-q --------------------------------------------------

    def _q(self, qs) -> np.ndarray:
        return np.asarray(qs, dtype=np.int64)[:, None]

    def add(self, a, b, qs):
        return (a + b) % self._q(qs)

    def sub(self, a, b, qs):
        return (a - b) % self._q(qs)

    def neg(self, a, qs):
        return (-a) % self._q(qs)

    def mul(self, a, b, qs):
        return a * b % self._q(qs)

    def mul_const(self, a, consts, qs):
        """Multiply limb l by scalar consts[l] mod qs[l]."""
        c = np.asarray(consts, dtype=np.int64)[:, None] % self._q(qs)
        return a * c % self._q(qs)

    def sum_terms(self, terms, qs):
        """Sum a list of arrays mod q (safe: inputs already reduced)."""
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc % self._q(qs)

    # -- per-axis tensor transforms -----------------------------------------

    def axis_matmul(self, a, mats, shape, qs):
        """Apply per-axis matrices along the tensor axes of a [L, n] array.

        mats: list over axes; mats[i] is either a numpy [d_out, d_in] matrix
        shared by all limbs, or a list of per-limb matrices. Output axis
        lengths may differ from input (embeddings/traces).
        """
        L = a.shape[0]
        q = np.asarray(qs, dtype=np.int64)
        cur_shape = list(shape)
        x = a.reshape(L, *cur_shape)
        for ax, mat in enumerate(mats):
            if mat is None:
                continue
            per_limb = isinstance(mat, (list, tuple))
            outs = []
            for l in range(L):
                M = np.asarray(mat[l] if per_limb else mat, dtype=np.int64) % q[l]
                xl = x[l]
                # move axis `ax` to front
                xl = np.moveaxis(xl, ax, 0)
                d_in = xl.shape[0]
                rest = xl.reshape(d_in, -1)
                prod = M[:, :, None] * rest[None, :, :] % q[l]
                res = prod.sum(axis=1) % q[l]
                res = res.reshape(M.shape[0], *xl.shape[1:])
                outs.append(np.moveaxis(res, 0, ax))
            cur_shape[ax] = outs[0].shape[ax]
            x = np.stack(outs, axis=0)
        return x.reshape(L, -1)

    # -- signed helpers (rescale path) --------------------------------------

    def lift_centered(self, a, qs):
        """Residues → centered signed representatives in (-q/2, q/2]."""
        q = self._q(qs)
        return np.where(a > q // 2, a - q, a)

    def reduce_signed(self, a_signed, qs):
        """Signed int64 values → residues mod per-limb q."""
        return a_signed % self._q(qs)

    def broadcast_row(self, row, nlimb, qs):
        """Take a single signed row [n] and reduce it into every limb."""
        q = self._q(qs)
        return np.broadcast_to(row[None, :], (nlimb, row.shape[0])) % q

    # -- composite device ops (shared semantics with backend/xla.py) ---------

    def stack_rows(self, rows):
        return np.stack(rows)

    def rescale_step(self, data, qs, zp):
        """Drop the last limb q_k: (data − δ)/q_k with δ ≡ data (mod q_k),
        δ ≡ 0 (mod zp), δ small. Exact; bit-identical across backends."""
        qs = tuple(qs)
        qk = qs[-1]
        new_qs = qs[:-1]
        r = data[-1].astype(np.int64)
        r = np.where(r > qk // 2, r - qk, r)
        t = (-r) * pow(qk, -1, zp) % zp
        t = np.where(t > zp // 2, t - zp, t)
        delta = r + qk * t
        out = []
        for i, q in enumerate(new_qs):
            inv_qk = pow(qk, -1, q)
            out.append((data[i] - delta) % q * inv_qk % q)
        return np.stack(out)

    def modswitch_up(self, data, old_qs, new_qs):
        """Exact scaling to a longer prefix: old limbs ×(∏ new extra limbs),
        new limbs ≡ 0."""
        d = 1
        for q in new_qs[len(old_qs):]:
            d *= q
        rows = [data[i] * (d % q) % q for i, q in enumerate(old_qs)]
        rows += [np.zeros(data.shape[1], dtype=np.int64) for _ in new_qs[len(old_qs):]]
        return np.stack(rows)

    def hybrid_digit_rows(self, data, qs, groups, ext_qs):
        """[dnum, T, n] hybrid digit rows: for each limb GROUP, the exact
        group-lift V_j < Q_j (Garner mixed-radix over the group's residue
        rows) reduced modulo every target limb of ext_qs. Integer-only —
        bit-identical semantics with the she/hybrid.py jnp formulation."""
        out = []
        off = 0
        for grp in groups:
            cnt = len(grp)
            rows = [data[off + k].astype(np.int64) % grp[k] for k in range(cnt)]
            pi = [1]
            for g in grp[:-1]:
                pi.append(pi[-1] * g)
            xs = [rows[0]]
            for k in range(1, cnt):
                g = grp[k]
                acc = xs[0] % g
                for j in range(1, k):
                    acc = (acc + xs[j] * (pi[j] % g)) % g
                inv = pow(pi[k] % g, -1, g)
                xs.append((rows[k] - acc) % g * inv % g)
            tgt = []
            for qt in ext_qs:
                acc = np.zeros_like(xs[0])
                for k in range(cnt):
                    acc = (acc + xs[k] * (pi[k] % qt)) % qt
                tgt.append(acc)
            out.append(np.stack(tgt))
            off += cnt
        return np.stack(out)

    def gadget_digit_rows(self, data, qs, base):
        """[D, L, n] digit rows of POW-basis residues. base=None → CRT/Triv
        digits (row i = limb-i residues reduced into every limb);
        base=b → per-limb base-b digits."""
        L = len(qs)
        qcol = np.asarray(qs, dtype=np.int64)[:, None]
        out = []
        for i, qi in enumerate(qs):
            row = data[i].astype(np.int64)
            if base is None:
                out.append(np.broadcast_to(row[None, :], (L, row.shape[0])) % qcol)
            else:
                nd = 0
                v = qi - 1
                while v:
                    nd += 1
                    v //= base
                for k in range(nd):
                    dig = (row // base**k) % base
                    out.append(np.broadcast_to(dig[None, :], (L, row.shape[0])) % qcol)
        return np.stack(out)
