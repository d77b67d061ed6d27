"""Fast path: negacyclic NTT and fused mul+relin/rescale, vs the golden Cyc."""

import numpy as np
import pytest

import jax.numpy as jnp

from alchemy_tpu.backend import golden_backend
from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.core.cyc import Cyc
from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams

GB = golden_backend()


def params(log_n=4, nlimb=2, zp=8):
    return FastParams.make(log_n, nlimb, zp=zp)


def test_ntt_roundtrip():
    p = params()
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs]).astype(np.uint32)
    y = intt_negacyclic(ntt_negacyclic(jnp.asarray(x), p.n, p.qs), p.n, p.qs)
    assert np.array_equal(np.asarray(y), x)


def test_ntt_mul_matches_golden_cyc():
    p = params()
    m = 2 * p.n  # cyclotomic index
    rng = np.random.default_rng(1)
    a = rng.integers(0, min(p.qs), p.n)
    b = rng.integers(0, min(p.qs), p.n)
    fa = ntt_negacyclic(jnp.asarray(np.stack([a % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    fb = ntt_negacyclic(jnp.asarray(np.stack([b % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    from alchemy_tpu.backend.xla import mulmod

    prod = intt_negacyclic(mulmod(fa, fb, p.qs), p.n, p.qs)
    ca = Cyc.from_coeffs(m, p.qs, np.stack([a % q for q in p.qs]), GB)
    cb = Cyc.from_coeffs(m, p.qs, np.stack([b % q for q in p.qs]), GB)
    want = GB.to_numpy((ca * cb).to_pow().data)
    assert np.array_equal(np.asarray(prod).astype(np.int64), want)


def test_fast_encrypt_decrypt():
    p = params(log_n=5, nlimb=2)
    rng = np.random.default_rng(2)
    s = fast.keygen(p, rng)
    msg = rng.integers(0, p.zp, p.n)
    ct = fast.encrypt(p, s, msg, rng)
    dec = fast.decrypt(p, s, ct)
    assert np.array_equal(dec, msg % p.zp)


def test_fast_mul_relin_and_rescale():
    p = params(log_n=5, nlimb=3, zp=2)
    rng = np.random.default_rng(3)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    m1 = rng.integers(0, 2, p.n)
    m2 = rng.integers(0, 2, p.n)
    ct1 = fast.encrypt(p, s, m1, rng)
    ct2 = fast.encrypt(p, s, m2, rng)
    out = fast.mul_relin(p, ct1, ct2, hb, ha)
    # plaintext product in the ring mod 2
    mm = 2 * p.n
    c1 = Cyc.from_coeffs(mm, (2,), m1, GB)
    c2 = Cyc.from_coeffs(mm, (2,), m2, GB)
    want = GB.to_numpy((c1 * c2).to_pow().data)[0]
    got = fast.decrypt(p, s, out)
    assert np.array_equal(got, want)


def test_fast_rescale_correct():
    p = params(log_n=5, nlimb=3, zp=2)
    rng = np.random.default_rng(4)
    from alchemy_tpu.she.keys import gaussian_coeffs

    s_int = gaussian_coeffs(rng, 1.0, p.n)
    s = ntt_negacyclic(
        jnp.asarray(np.stack([s_int % q for q in p.qs]).astype(np.uint32)), p.n, p.qs
    )
    msg = rng.integers(0, 2, p.n)
    ct = fast.encrypt(p, s, msg, rng)
    down = fast.rescale(p, ct, 1)
    p_down = FastParams(n=p.n, qs=p.qs[:-1], zp=p.zp, impl=p.impl)
    s_down = ntt_negacyclic(
        jnp.asarray(np.stack([s_int % q for q in p_down.qs]).astype(np.uint32)),
        p_down.n, p_down.qs,
    )
    # the dropped prime is ≡ 1 mod 2 ... scale factor: q_k mod 2 = 1
    got = fast.decrypt(p_down, s_down, down)
    assert np.array_equal(got, msg % 2)


def test_mxu_ntt_matches_ring_mul():
    # exactness of the digit-plane matmul path at a small size
    import jax.numpy as jnp
    from alchemy_tpu.backend.ntt_mxu import intt_mxu, ntt_mxu
    from alchemy_tpu.backend.xla import mulmod

    p = FastParams.make(8, 2, zp=8)
    m = 2 * p.n
    rng = np.random.default_rng(9)
    a = rng.integers(0, min(p.qs), p.n)
    b = rng.integers(0, min(p.qs), p.n)
    fa = ntt_mxu(jnp.asarray(np.stack([a % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    fb = ntt_mxu(jnp.asarray(np.stack([b % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    prod = intt_mxu(mulmod(fa, fb, p.qs), p.n, p.qs)
    ca = Cyc.from_coeffs(m, p.qs, np.stack([a % q for q in p.qs]), GB)
    cb = Cyc.from_coeffs(m, p.qs, np.stack([b % q for q in p.qs]), GB)
    want = GB.to_numpy((ca * cb).to_pow().data)
    assert np.array_equal(np.asarray(prod).astype(np.int64), want)


def test_fast_mul_relin_mxu_impl():
    p = FastParams.make(6, 2, zp=2, impl="mxu")
    rng = np.random.default_rng(10)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    m1 = rng.integers(0, 2, p.n)
    m2 = rng.integers(0, 2, p.n)
    ct1 = fast.encrypt(p, s, m1, rng)
    ct2 = fast.encrypt(p, s, m2, rng)
    out = fast.mul_relin(p, ct1, ct2, hb, ha)
    mm = 2 * p.n
    c1 = Cyc.from_coeffs(mm, (2,), m1, GB)
    c2 = Cyc.from_coeffs(mm, (2,), m2, GB)
    want = GB.to_numpy((c1 * c2).to_pow().data)[0]
    assert np.array_equal(fast.decrypt(p, s, out), want)


def test_fast_mul_relin_mxu_matches_vpu():
    """The mxu path feeds UNREDUCED limb residues into the digit NTT (the
    matmul recombination reduces mod the target modulus for free —
    she/fast.py mul_relin); this pins its decrypt against the vpu path,
    which reduces digits explicitly, on a multi-limb config."""
    results = {}
    for impl in ("mxu", "vpu"):
        p = FastParams.make(8, 3, zp=2, impl=impl)
        rng = np.random.default_rng(11)
        s = fast.keygen(p, rng)
        hb, ha = fast.relin_hint(p, s, rng, shoup=True)
        m1 = rng.integers(0, 2, p.n)
        m2 = rng.integers(0, 2, p.n)
        ct1 = fast.encrypt(p, s, m1, rng)
        ct2 = fast.encrypt(p, s, m2, rng)
        out = fast.mul_relin(p, ct1, ct2, hb, ha)
        results[impl] = fast.decrypt(p, s, out)
    assert np.array_equal(results["mxu"], results["vpu"])


def test_deep_circuit_depth16():
    from alchemy_tpu.examples.deep_circuit import run

    ok, depth = run(log_n=8, depth=16, verbose=False, impl="vpu")
    assert ok and depth == 16


@pytest.mark.parametrize("ks", ["trivgad", "hybrid"])
def test_deep_circuit_levels_compiled_up_front(ks, monkeypatch, caplog):
    """Every level's hint, mul+relin and rescale program compiles in
    compile_levels; the level loop reuses them and compiles none again."""
    import logging
    import re

    import jax

    from alchemy_tpu.examples import deep_circuit

    level_fns = {"_relin_hint_rows", "_hybrid_hint_rows", "mul_relin",
                 "mul_relin_hybrid", "rescale"}
    real, mark = deep_circuit.compile_levels, {}

    def compile_then_mark(*args):
        real(*args)
        mark["at"] = len(caplog.records)

    def compiled(records):
        found = (re.match(r"Compiling jit\((\w+)\)", r.getMessage())
                 for r in records)
        return {m.group(1) for m in found if m}

    monkeypatch.setattr(deep_circuit, "compile_levels", compile_then_mark)
    jax.clear_caches()
    # set globally: compile_levels compiles in worker threads, which do not
    # see a context manager's thread-local setting
    jax.config.update("jax_log_compiles", True)
    try:
        with caplog.at_level(logging.WARNING):
            ok, _ = deep_circuit.run(log_n=6, depth=3, ks=ks, verbose=False,
                                     impl="vpu")
    finally:
        jax.config.update("jax_log_compiles", False)
    assert ok
    up_front = compiled(caplog.records[:mark["at"]]) & level_fns
    assert up_front >= {"rescale", "mul_relin_hybrid" if ks == "hybrid"
                        else "mul_relin"}
    assert not compiled(caplog.records[mark["at"]:]) & level_fns


def test_mul_relin_batched_leading_dims():
    import jax.numpy as jnp

    p = FastParams.make(5, 2, zp=2, impl="vpu")
    rng = np.random.default_rng(12)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    m1 = rng.integers(0, 2, p.n)
    m2 = rng.integers(0, 2, p.n)
    ct1 = fast.encrypt(p, s, m1, rng)
    ct2 = fast.encrypt(p, s, m2, rng)
    single = fast.mul_relin(p, ct1, ct2, hb, ha)
    batched = fast.mul_relin(
        p,
        jnp.broadcast_to(ct1[None], (3, *ct1.shape)),
        jnp.broadcast_to(ct2[None], (3, *ct2.shape)),
        hb, ha,
    )
    for b in range(3):
        assert np.array_equal(np.asarray(batched[b]), np.asarray(single))


def test_cost_table():
    from alchemy_tpu.utils.profiling import cost_table
    from alchemy_tpu.examples.arithmetic import addMul

    table = dict(cost_table(addMul))
    assert table["add_"] == 1 and table["mul_"] == 1


def test_ntt_mxu_bcast_matches_broadcast():
    """The broadcast NTT (stage-1 contraction of un-broadcast digit rows)
    is bit-identical to ntt_mxu over the materialized [D, L, n] fan-out —
    including for UNREDUCED uint32 inputs, the relin digit case."""
    import jax.numpy as jnp
    from alchemy_tpu.backend.ntt_mxu import ntt_mxu, ntt_mxu_bcast

    p = FastParams.make(8, 3, zp=2)
    L = len(p.qs)
    rng = np.random.default_rng(11)
    # full-range u32 rows (digits enter unreduced)
    x = rng.integers(0, 1 << 32, (4, p.n), dtype=np.uint64).astype(np.uint32)
    xd = jnp.asarray(x)
    got = ntt_mxu_bcast(xd, p.n, p.qs)
    want = ntt_mxu(jnp.broadcast_to(xd[:, None, :], (4, L, p.n)), p.n, p.qs)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    # leading batch dims (the batched-SIMD relin path)
    xb = rng.integers(0, 1 << 32, (2, 4, p.n), dtype=np.uint64).astype(np.uint32)
    gotb = ntt_mxu_bcast(jnp.asarray(xb), p.n, p.qs)
    for b in range(2):
        one = ntt_mxu_bcast(jnp.asarray(xb[b]), p.n, p.qs)
        assert np.array_equal(np.asarray(gotb[b]), np.asarray(one))


def test_ntt_mxu_int8_bit_identical():
    """The int8 merged-plane matmul path (i8=True) is bit-identical to the
    bf16 digit-plane path on forward/inverse/broadcast NTTs, including
    unreduced u32 inputs, and end-to-end through mul_relin + decrypt."""
    from alchemy_tpu.backend.ntt_mxu import intt_mxu, ntt_mxu, ntt_mxu_bcast

    p = FastParams.make(8, 3, zp=2)
    rng = np.random.default_rng(12)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs]).astype(np.uint32)
    xd = jnp.asarray(x)
    f0, f1 = ntt_mxu(xd, p.n, p.qs, False), ntt_mxu(xd, p.n, p.qs, True)
    assert np.array_equal(np.asarray(f0), np.asarray(f1))
    assert np.array_equal(np.asarray(intt_mxu(f1, p.n, p.qs, True)), x)
    xr = jnp.asarray(
        rng.integers(0, 1 << 32, (4, p.n), dtype=np.uint64).astype(np.uint32)
    )
    assert np.array_equal(
        np.asarray(ntt_mxu_bcast(xr, p.n, p.qs, False)),
        np.asarray(ntt_mxu_bcast(xr, p.n, p.qs, True)),
    )
    # end-to-end: impl="mxu8" mul_relin decrypts to the plaintext product
    p8 = FastParams.make(6, 3, zp=2, impl="mxu8")
    rng = np.random.default_rng(13)
    s = fast.keygen(p8, rng)
    hb, ha = fast.relin_hint(p8, s, rng, shoup=True)
    m1, m2 = rng.integers(0, 2, p8.n), rng.integers(0, 2, p8.n)
    out = fast.mul_relin(
        p8,
        fast.encrypt(p8, s, m1, rng),
        fast.encrypt(p8, s, m2, rng),
        hb,
        ha,
    )
    mm = 2 * p8.n
    c1 = Cyc.from_coeffs(mm, (2,), m1, GB)
    c2 = Cyc.from_coeffs(mm, (2,), m2, GB)
    want = GB.to_numpy((c1 * c2).to_pow().data)[0]
    assert np.array_equal(fast.decrypt(p8, s, out), want)


def test_mxu3_r4_roundtrip_and_product():
    """3-factor NTT at 2^16 (radix 4): exact roundtrip, and the negacyclic
    square agrees with the butterfly transform's."""
    from alchemy_tpu.backend.ntt_mxu3 import _split3, intt_mxu3, ntt_mxu3
    from alchemy_tpu.backend.xla import mulmod

    assert _split3(1 << 16) == (128, 128, 4)
    p = FastParams.make(16, 2)
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs]).astype(np.uint32)
    xd = jnp.asarray(x)
    y = ntt_mxu3(xd, p.n, p.qs)
    assert np.array_equal(np.asarray(intt_mxu3(y, p.n, p.qs)), x)
    y2 = ntt_negacyclic(xd, p.n, p.qs)
    sq_mxu = intt_mxu3(mulmod(y, y, p.qs), p.n, p.qs)
    sq_vpu = intt_negacyclic(mulmod(y2, y2, p.qs), p.n, p.qs)
    assert np.array_equal(np.asarray(sq_mxu), np.asarray(sq_vpu))


@pytest.mark.parametrize("K", [128, 256, 512])
def test_fast_recombine_exact_at_bounds(K):
    """Property-pin the byte-serial recombination of ntt_mxu._recombine_planes:
    for plane sums up to the WORST-CASE bounds of the digit-plane dots
    (s_f ≤ 4·K·255·255 for f ≤ 2, s_3 ≤ 4·K·255·63 — the scaled weights'
    top byte is < 64 for q < 2^30), fast_ok=True returns the exact residue
    of Σ_f 2^(8f)·s_f for random ~30-bit NTT-style primes, including the
    extreme corner (all sums at their maxima). At K = 512 the byte-serial
    assembly would overflow u32 there, so the K ≤ 256 guard must send the
    sums down the exact carry chain."""
    from alchemy_tpu.backend.ntt_mxu import _recombine_planes
    from alchemy_tpu.backend.xla import shoup_const

    rng = np.random.default_rng(12)
    smax = 4 * K * 255 * 255
    s3max = 4 * K * 255 * 63
    qs = [((1 << 30) - rng.integers(1, 1 << 20)) | 1 for _ in range(3)]
    qs.append((1 << 30) - 1)                      # extreme q
    for q in map(int, qs):
        t = {k: np.array([[v]], dtype=np.uint32) for k, v in (
            ("q", q), ("r16", (1 << 16) % q),
            ("r16s", shoup_const((1 << 16) % q, q)),
            ("r32", (1 << 32) % q), ("r32s", shoup_const((1 << 32) % q, q)))}
        cols = 64
        s0 = rng.integers(0, smax + 1, cols).astype(np.uint64)
        s1 = rng.integers(0, smax + 1, cols).astype(np.uint64)
        s2 = rng.integers(0, smax + 1, cols).astype(np.uint64)
        s3 = rng.integers(0, s3max + 1, cols).astype(np.uint64)
        # corner: every sum at its max simultaneously
        s0[0], s1[0], s2[0], s3[0] = smax, smax, smax, s3max
        sums = [jnp.asarray(s.astype(np.uint32)[None]) for s in (s0, s1, s2, s3)]
        value = (s0.astype(object) + (s1.astype(object) << 8)
                 + (s2.astype(object) << 16) + (s3.astype(object) << 24))
        got = np.asarray(_recombine_planes(sums, t, K, fast_ok=True))[0]
        want = np.array([int(v) % q for v in value], dtype=np.uint32)
        assert np.array_equal(got, want), (q, K)
