"""The fast path's NTT formulations agree bit for bit in the coefficient
domain, with each other and with the native C++ mul+relin; one default
formulation serves every platform; the hybrid path runs under the 3-factor
one."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alchemy_tpu.backend.ntt import intt_negacyclic
from alchemy_tpu.nt.primes import root_of_unity
from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import IMPLS, FastParams

native = pytest.importorskip("alchemy_tpu.native")


def negacyclic_mod2(a, b):
    n = len(a)
    conv = np.convolve(a.astype(np.int64), b.astype(np.int64))
    return (conv[:n] + np.concatenate([conv[n:], [0]])) % 2


@pytest.fixture(scope="module")
def coeff_case():
    """Two ciphertexts and a relin hint at 2^8, L=3, in the coefficient
    domain, plus the native C++ product (coefficient domain)."""
    p = FastParams.make(8, 3, zp=2, impl="vpu")
    rng = np.random.default_rng(21)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct_a = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    ct_b = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    psis = [root_of_unity(2 * p.n, q) for q in p.qs]
    nat = native.mul_relin(*(np.asarray(x) for x in (ct_a, ct_b, hb, ha)),
                           p.qs, psis)

    def coeff(x):
        return intt_negacyclic(jnp.asarray(x), p.n, p.qs)

    return p, [coeff(x) for x in (ct_a, ct_b, hb, ha)], np.asarray(coeff(nat))


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
@pytest.mark.parametrize("impl", IMPLS)
def test_mul_relin_coeff_identical_to_native(coeff_case, impl, shoup):
    p0, (a, b, hb, ha), want = coeff_case
    p = FastParams(n=p0.n, qs=p0.qs, zp=p0.zp, impl=impl)
    a, b, hb, ha = (fast._ntt_p(p, x) for x in (a, b, hb, ha))
    if shoup:
        hb, ha = fast.shoup_precompute(hb, p.qs), fast.shoup_precompute(ha, p.qs)
    out = fast.mul_relin(p, a, b, hb, ha)
    assert np.array_equal(np.asarray(fast._intt_p(p, out)), want)


def test_mul_relin_batched_distinct_mxu3():
    """A batch of distinct ciphertexts under the 3-factor formulation: each
    row equals its own unbatched product and decrypts to a·b."""
    p = FastParams.make(11, 3, zp=2, impl="mxu3")   # A = B = 32, r = 2
    rng = np.random.default_rng(3)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    ma = rng.integers(0, 2, (3, p.n))
    mb = rng.integers(0, 2, (3, p.n))
    ca = jnp.stack([fast.encrypt(p, s, m, rng) for m in ma])
    cb = jnp.stack([fast.encrypt(p, s, m, rng) for m in mb])
    out = fast.mul_relin(p, ca, cb, hb, ha)
    for i in range(3):
        one = fast.mul_relin(p, ca[i], cb[i], hb, ha)
        assert np.array_equal(np.asarray(out[i]), np.asarray(one)), i
        assert np.array_equal(fast.decrypt(p, s, out[i]),
                              negacyclic_mod2(ma[i], mb[i])), i


@pytest.fixture(scope="module")
def hybrid_2e14():
    from alchemy_tpu.she.hybrid import HybridKS, hybrid_keygen_hint

    p = FastParams.make(14, 4, zp=2, impl="mxu3")
    hk = HybridKS.make(p)
    rng = np.random.default_rng(11)
    s, hints = hybrid_keygen_hint(hk, rng)
    m1, m2 = rng.integers(0, 2, p.n), rng.integers(0, 2, p.n)
    cts = (fast.encrypt(p, s, m1, rng), fast.encrypt(p, s, m2, rng))
    return p, hk, s, hints, cts, negacyclic_mod2(m1, m2)


def test_hybrid_mul_relin_mxu3_2e14(hybrid_2e14):
    """Hybrid mul+relin at 2^14 under mxu3 decrypts to the plaintext
    product (the §4 differential oracle)."""
    from alchemy_tpu.she.hybrid import mul_relin_hybrid

    p, hk, s, hints, (c1, c2), want = hybrid_2e14
    out = mul_relin_hybrid(hk, c1, c2, *hints)
    assert np.array_equal(fast.decrypt(p, s, out), want)


def test_rescale_joint_mxu3_2e14(hybrid_2e14):
    """The joint rescale by two limbs at 2^14 under mxu3 decrypts under the
    shortened chain, and dropping one limb equals fast.rescale."""
    from alchemy_tpu.she.hybrid import rescale_joint

    p, _, s, _, (c1, _), _ = hybrid_2e14
    msg = fast.decrypt(p, s, c1)
    down = rescale_joint(p, c1, 2)
    p2 = FastParams(n=p.n, qs=p.qs[:-2], zp=p.zp, impl=p.impl)
    assert np.array_equal(fast.decrypt(p2, s[:-2], down), msg)
    assert np.array_equal(np.asarray(rescale_joint(p, c1, 1)),
                          np.asarray(fast.rescale(p, c1, 1)))


@pytest.mark.parametrize("platform,log_n,want", [
    ("cpu", 15, "vpu"), ("gpu", 14, "vpu"), ("gpu", 15, "vpu"),
    ("gpu", 16, "vpu"), ("gpu", 12, "vpu")])
def test_default_impl_by_platform(monkeypatch, platform, log_n, want):
    """One default formulation, the butterflies, whatever the platform
    and the ring size."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert FastParams(n=1 << log_n, qs=()).impl == fast.DEFAULT_IMPL == want


def test_fast_params_resolve_and_reject_impl():
    """No formulation given: the default one. An unknown one, such as the
    removed "pallas", fails loudly."""
    assert FastParams.make(6, 2).impl == fast.DEFAULT_IMPL == "vpu"
    removed = "pallas"
    with pytest.raises(ValueError, match=removed):
        FastParams.make(6, 2, impl=removed)

