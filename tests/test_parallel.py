"""Distributed path on the virtual 8-device CPU mesh: the 4-step
coeff-sharded NTT and the limb-sharded fused mul+relin, validated
bit-exactly against the single-chip fast path through layout bridges."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.parallel.dist import (
    DistConfig,
    from_dist_layout,
    make_dist_mul_relin,
    make_dist_ntt,
    to_dist_layout,
)
from alchemy_tpu.parallel.mesh import make_mesh
from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def setup(log_n=8, nlimb=4, n1=None):
    p = FastParams.make(log_n, nlimb, zp=2)
    n1 = n1 or (1 << (log_n // 2))
    cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
    mesh = make_mesh((2, 2, 2))
    return p, cfg, mesh


@pytest.mark.parametrize("n1", [4, 16])
def test_dist_layout_is_the_j2_j1_order(n1):
    """Storage slot j2·n1 + j1 holds coefficient j1·n2 + j2, and
    from_dist_layout undoes it (leading axes pass through)."""
    _, cfg, _ = setup(n1=n1)
    coeffs = np.arange(3 * cfg.p.n).reshape(3, cfg.p.n)
    stored = to_dist_layout(coeffs, cfg)
    for j2 in range(cfg.n2):
        for j1 in range(cfg.n1):
            assert stored[1, j2 * cfg.n1 + j1] == coeffs[1, j1 * cfg.n2 + j2]
    assert np.array_equal(from_dist_layout(stored, cfg), coeffs)


def test_dist_ntt_roundtrip():
    p, cfg, mesh = setup()
    rng = np.random.default_rng(0)
    x = np.stack(
        [np.stack([rng.integers(0, q, p.n) for q in p.qs]) for _ in range(2)]
    ).astype(np.uint32)  # [B=2, L, n]
    fwd, inv = make_dist_ntt(cfg, mesh)
    y = inv(fwd(jnp.asarray(x)))
    assert np.array_equal(np.asarray(y), x)


def test_dist_ntt_pointwise_mul_is_ring_mul():
    p, cfg, mesh = setup()
    rng = np.random.default_rng(1)
    a = rng.integers(0, min(p.qs), p.n)
    b = rng.integers(0, min(p.qs), p.n)
    fwd, inv = make_dist_ntt(cfg, mesh)

    def to_dev(v):
        res = np.stack([v % q for q in p.qs]).astype(np.uint32)
        stored = to_dist_layout(res, cfg)
        return jnp.asarray(np.stack([stored, stored]))  # pad batch to 2

    from alchemy_tpu.backend.xla import mulmod

    fa, fb = fwd(to_dev(a)), fwd(to_dev(b))
    prod = inv(mulmod(fa, fb, p.qs))
    got = from_dist_layout(np.asarray(prod)[0], cfg).astype(np.int64)
    # reference: single-chip negacyclic via the fast path
    na = ntt_negacyclic(jnp.asarray(np.stack([a % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    nb = ntt_negacyclic(jnp.asarray(np.stack([b % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    want = np.asarray(intt_negacyclic(mulmod(na, nb, p.qs), p.n, p.qs)).astype(np.int64)
    assert np.array_equal(got, want)


def test_dist_deep_chain_mul_relin_rescale():
    """Depth-3 mul+relin+rescale chain on the mesh (BASELINE configs[3]
    distributed): the ciphertext stays at the full padded allocation
    [B, 2, L0, n] (fixed limb sharding, shrinking active prefix) and every
    level is validated bit-exactly against the single-chip fast path; the
    final level decrypts to the Frobenius squaring-chain plaintext."""
    from alchemy_tpu.examples.deep_circuit import expected_square_chain_mod2
    from alchemy_tpu.parallel.dist import make_dist_rescale
    from alchemy_tpu.she.keys import gaussian_coeffs

    depth = 3
    L0 = 6
    p = FastParams.make(7, L0, zp=2)
    cfg = DistConfig(p=p, n1=8, n2=p.n // 8)
    mesh = make_mesh((2, 2, 2))
    rng = np.random.default_rng(3)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        res = np.stack([s_int % q for q in pp.qs]).astype(np.uint32)
        return fast._ntt_p(pp, jnp.asarray(res))

    msg = rng.integers(0, 2, p.n)
    ct_f = fast.encrypt(p, key_at(p), msg, rng)

    def coeffs_of(ct, pp):
        return np.asarray(fast._intt_p(pp, ct))

    def to_dist_ntt(coeff_rows):
        """[..., L0, n] coefficient rows (padded) → dist NTT domain."""
        stored = to_dist_layout(coeff_rows, cfg)
        lead = stored.shape[:-2]
        flat = stored.reshape(-1, L0, p.n)
        # pad batch to the mesh batch size
        out = np.asarray(fwd(jnp.asarray(
            np.concatenate([flat, flat], axis=0))))[: flat.shape[0]]
        return out.reshape(*lead, L0, p.n)

    fwd, inv = make_dist_ntt(cfg, mesh)
    run_mul = make_dist_mul_relin(cfg, mesh)

    c0 = coeffs_of(ct_f, p)                       # [2, L0, n]
    ct_d = jnp.asarray(np.stack([to_dist_ntt(c0)] * 2))   # [B=2, 2, L0, n]

    cur_p = p
    for level in range(depth):
        act = len(cur_p.qs)
        sl = key_at(cur_p)
        hb, ha = fast.relin_hint(cur_p, sl, rng)
        # single-chip reference level
        ct_f = fast.mul_relin(cur_p, ct_f, ct_f, hb, ha)
        ct_f = fast.rescale(cur_p, ct_f, 1)
        next_p = FastParams(n=p.n, qs=cur_p.qs[:-1], zp=p.zp, impl=p.impl)
        # mesh level: pad hints to [L0, L0, n] in the dist NTT domain
        hbp = np.zeros((L0, L0, p.n), dtype=np.uint32)
        hap = np.zeros((L0, L0, p.n), dtype=np.uint32)
        hb_c = coeffs_of(hb, cur_p)               # [act, act, n]
        ha_c = coeffs_of(ha, cur_p)
        pad_b = np.zeros((act, L0, p.n), dtype=np.uint32)
        pad_a = np.zeros((act, L0, p.n), dtype=np.uint32)
        pad_b[:, :act] = hb_c
        pad_a[:, :act] = ha_c
        hbp[:act] = to_dist_ntt(pad_b)
        hap[:act] = to_dist_ntt(pad_a)
        out_d = run_mul(ct_d, ct_d, jnp.asarray(hbp), jnp.asarray(hap))
        ct_d = make_dist_rescale(cfg, mesh, act)(out_d)
        # bit-exact per-level check against the single-chip chain
        got = from_dist_layout(np.asarray(inv(ct_d.reshape(4, L0, p.n))), cfg)
        got = got.reshape(2, 2, L0, p.n)
        assert np.array_equal(got[0], got[1])
        want = coeffs_of(ct_f, next_p)            # [2, act-1, n]
        assert np.array_equal(got[0][:, : act - 1], want), f"level {level}"
        assert not got[0][:, act - 1 :].any()
        cur_p = next_p

    dec = fast.decrypt(cur_p, key_at(cur_p), ct_f)
    assert np.array_equal(dec, expected_square_chain_mod2(msg, p.n, depth))


def test_dist_mul_relin_matches_single_chip():
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(2)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    m1 = rng.integers(0, 2, p.n)
    m2 = rng.integers(0, 2, p.n)
    ct1 = fast.encrypt(p, s, m1, rng)
    ct2 = fast.encrypt(p, s, m2, rng)
    want = fast.mul_relin(p, ct1, ct2, hb, ha)
    want_coeff = np.asarray(intt_negacyclic(want, p.n, p.qs))

    # bridge: fast NTT domain → coefficients → dist layout → dist NTT domain
    # (batch axis padded to the mesh batch size)
    fwd, inv = make_dist_ntt(cfg, mesh)

    def bridge(x):
        coeff = np.asarray(intt_negacyclic(x, p.n, p.qs))
        stored = to_dist_layout(coeff, cfg)
        return np.asarray(fwd(jnp.asarray(np.stack([stored, stored]))))[0]

    def unbridge(x):
        two = jnp.asarray(np.stack([x, x]))
        return from_dist_layout(np.asarray(inv(two))[0], cfg)

    d_ct = lambda ct: np.stack([bridge(ct[0]), bridge(ct[1])])
    d1, d2 = d_ct(ct1), d_ct(ct2)
    batch1 = jnp.asarray(np.stack([d1, d1]))  # [B=2, 2, L, n]
    batch2 = jnp.asarray(np.stack([d2, d2]))
    d_hb = jnp.asarray(np.stack([bridge(hb[i]) for i in range(len(p.qs))]))
    d_ha = jnp.asarray(np.stack([bridge(ha[i]) for i in range(len(p.qs))]))

    run = make_dist_mul_relin(cfg, mesh)
    out = np.asarray(run(batch1, batch2, d_hb, d_ha))  # [2, 2, L, n]
    assert np.array_equal(out[0], out[1])
    got0 = unbridge(out[0, 0])
    got1 = unbridge(out[0, 1])
    assert np.array_equal(got0, want_coeff[0])
    assert np.array_equal(got1, want_coeff[1])


def test_ring_strategy_matches_a2a():
    """The staged-ring ppermute transpose (DIST_STRATEGIES['ring']) is
    bit-identical to the all_to_all strategy for NTT and fused mul+relin."""
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(7)
    x = np.stack(
        [np.stack([rng.integers(0, q, p.n) for q in p.qs]) for _ in range(2)]
    ).astype(np.uint32)
    fwd_a, inv_a = make_dist_ntt(cfg, mesh, strategy="a2a")
    fwd_r, inv_r = make_dist_ntt(cfg, mesh, strategy="ring")
    ya, yr = fwd_a(jnp.asarray(x)), fwd_r(jnp.asarray(x))
    assert np.array_equal(np.asarray(ya), np.asarray(yr))
    assert np.array_equal(np.asarray(inv_r(yr)), x)

    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    d = np.stack([np.asarray(ct)] * 2).astype(np.uint32)  # [B=2, 2, L, n]
    # fake dist layout is fine: both strategies see identical inputs and only
    # cross-strategy equality matters
    args = (jnp.asarray(d),) * 2 + (
        jnp.asarray(np.stack([np.asarray(hb[i]) for i in range(len(p.qs))])),
        jnp.asarray(np.stack([np.asarray(ha[i]) for i in range(len(p.qs))])),
    )
    out_a = make_dist_mul_relin(cfg, mesh, strategy="a2a")(*args)
    out_r = make_dist_mul_relin(cfg, mesh, strategy="ring")(*args)
    assert np.array_equal(np.asarray(out_a), np.asarray(out_r))


def test_pick_dist_strategy_single_process():
    from alchemy_tpu.parallel.dist import pick_dist_strategy

    _, _, mesh = setup()
    assert pick_dist_strategy(mesh) == "a2a"  # all_to_all everywhere


def test_dist_ntt_communication_pattern():
    """Communication-pattern sanity (VERDICT r2 #10): the a2a forward NTT
    lowers to EXACTLY ONE all_to_all and no other inter-device collective;
    the ring variant lowers to C-1 collective permutes and no all_to_all."""
    p, cfg, mesh = setup(log_n=8, nlimb=4)
    C = mesh.shape["coeff"]
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.stack(
        [np.stack([rng.integers(0, q, p.n) for q in p.qs]) for _ in range(2)]
    ).astype(np.uint32))

    fwd_a, _ = make_dist_ntt(cfg, mesh, strategy="a2a")
    txt = fwd_a.lower(x).as_text()
    assert txt.count("all_to_all") == 1
    assert "collective_permute" not in txt

    fwd_r, _ = make_dist_ntt(cfg, mesh, strategy="ring")
    txt_r = fwd_r.lower(x).as_text()
    assert "all_to_all" not in txt_r
    assert txt_r.count("collective_permute") == C - 1


def test_dist_mul_relin_large_batch_dp():
    """configs[4] mesh claim: a ciphertext batch LARGER than the mesh (B=16
    on 2 batch shards) runs DP+limb+coeff-sharded and every batch row matches
    the single-chip fast path bit-exactly."""
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    B = 16
    rng = np.random.default_rng(9)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    cts = [fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(B)]

    fwd, inv = make_dist_ntt(cfg, mesh)

    def bridge_rows(rows):
        """[K, L, n] fast-NTT-domain rows → dist NTT domain (one fwd call)."""
        coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, p.qs))
        stored = to_dist_layout(coeff, cfg)
        return np.asarray(fwd(jnp.asarray(stored)))

    d_cts = bridge_rows(
        np.stack([np.asarray(c) for c in cts]).reshape(2 * B, len(p.qs), p.n)
    ).reshape(B, 2, len(p.qs), p.n)
    d_hb = bridge_rows(np.stack([np.asarray(hb[i]) for i in range(len(p.qs))]))
    d_ha = bridge_rows(np.stack([np.asarray(ha[i]) for i in range(len(p.qs))]))

    run = make_dist_mul_relin(cfg, mesh)
    # pairwise products ct[i] * ct[(i+1) % B], all in one sharded call
    other = jnp.asarray(np.roll(d_cts, -1, axis=0))
    out = np.asarray(run(jnp.asarray(d_cts), other, jnp.asarray(d_hb),
                         jnp.asarray(d_ha)))
    got = np.asarray(inv(jnp.asarray(out.reshape(2 * B, len(p.qs), p.n))))
    got = from_dist_layout(got, cfg).reshape(B, 2, len(p.qs), p.n)
    for i in range(B):
        want = fast.mul_relin(p, cts[i], cts[(i + 1) % B], hb, ha)
        want_coeff = np.asarray(intt_negacyclic(want, p.n, p.qs))
        assert np.array_equal(got[i], want_coeff), f"row {i}"


def test_row_hint_placement_matches_digit():
    """EP-analog gadget-row hint sharding (hint_placement='row'): hints are
    row-sharded over 'limb' (per-device hint memory drops limb_shards×),
    combined by one psum — bit-identical to the default digit placement."""
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(13)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    d = np.stack([np.asarray(ct)] * 2).astype(np.uint32)
    args = (jnp.asarray(d),) * 2 + (
        jnp.asarray(np.stack([np.asarray(hb[i]) for i in range(len(p.qs))])),
        jnp.asarray(np.stack([np.asarray(ha[i]) for i in range(len(p.qs))])),
    )
    out_d = make_dist_mul_relin(cfg, mesh)(*args)
    out_r = make_dist_mul_relin(cfg, mesh, hint_placement="row")(*args)
    assert np.array_equal(np.asarray(out_d), np.asarray(out_r))


def test_dist_mul_relin_hybrid_matches_single():
    """Hybrid KS on the mesh (VERDICT r3 #3): the deep configuration's
    gadget — dnum digit groups + special modulus P — runs limb+coeff+batch
    sharded, bit-exact vs she/hybrid.mul_relin_hybrid on every batch row.
    L=12 → dnum=3, α=4, K=4, extended chain T=16."""
    from alchemy_tpu.parallel.dist import make_dist_mul_relin_hybrid
    from alchemy_tpu.she.hybrid import (
        HybridKS,
        hybrid_keygen_hint,
        mul_relin_hybrid,
    )

    L = 12
    p = FastParams.make(7, L, zp=2)
    n1 = 8
    cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
    mesh = make_mesh((2, 2, 2))
    hk = HybridKS.make(p)
    assert len(hk.pe.qs) == 16 and len(hk.groups) == 3
    rng = np.random.default_rng(21)
    s, (hb, ha) = hybrid_keygen_hint(hk, rng)
    cts_a = [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
             for _ in range(2)]
    cts_b = [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
             for _ in range(2)]
    wants = [
        np.asarray(intt_negacyclic(
            mul_relin_hybrid(hk, a, b, hb, ha), p.n, p.qs))
        for a, b in zip(cts_a, cts_b)
    ]

    fwd_b, inv_b = make_dist_ntt(cfg, mesh)
    cfg_e = DistConfig(p=hk.pe, n1=n1, n2=p.n // n1)
    fwd_e, _ = make_dist_ntt(cfg_e, mesh)

    def bridge(rows, qs, fwd):
        coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, qs))
        return np.asarray(fwd(jnp.asarray(to_dist_layout(coeff, cfg))))

    d_a = bridge(np.stack([np.asarray(c) for c in cts_a]).reshape(4, L, p.n),
                 p.qs, fwd_b).reshape(2, 2, L, p.n)
    d_b = bridge(np.stack([np.asarray(c) for c in cts_b]).reshape(4, L, p.n),
                 p.qs, fwd_b).reshape(2, 2, L, p.n)
    # hints: [dnum=3, T, n] — pad to 4 rows for the batch-axis bridge
    def bridge_hint(hrows):
        h4 = np.concatenate(
            [np.asarray(hrows), np.zeros_like(np.asarray(hrows[:1]))], axis=0)
        return bridge(h4, hk.pe.qs, fwd_e)[:3]

    d_hb, d_ha = bridge_hint(hb), bridge_hint(ha)

    run = make_dist_mul_relin_hybrid(hk, cfg, mesh)
    out = run(jnp.asarray(d_a), jnp.asarray(d_b),
              jnp.asarray(d_hb), jnp.asarray(d_ha))
    got = np.asarray(inv_b(jnp.asarray(np.asarray(out).reshape(4, L, p.n))))
    got = from_dist_layout(got, cfg).reshape(2, 2, L, p.n)
    for i in range(2):
        assert np.array_equal(got[i], wants[i].reshape(2, L, p.n)), f"row {i}"


def test_dist_ntt_overlapped_transpose_bit_identical(monkeypatch):
    """ALCHEMY_DIST_OVERLAP=nc splits the transpose into nc
    destination-aligned chunks whose exchange+butterfly chains are
    dataflow-independent (comm/compute overlap; VERDICT r4 missing #2):
    forward and inverse stay bit-identical to the one-shot a2a, the
    roundtrip still inverts, and the lowering carries nc independent
    all_to_alls."""
    p, cfg, mesh = setup(log_n=8, nlimb=4)
    rng = np.random.default_rng(4)
    x = jnp.asarray(np.stack(
        [np.stack([rng.integers(0, q, p.n) for q in p.qs]) for _ in range(2)]
    ).astype(np.uint32))
    fwd1, inv1 = make_dist_ntt(cfg, mesh)
    y1 = np.asarray(fwd1(x))
    r1 = np.asarray(inv1(jnp.asarray(y1)))
    monkeypatch.setenv("ALCHEMY_DIST_OVERLAP", "2")
    fwd2, inv2 = make_dist_ntt(cfg, mesh)
    y2 = np.asarray(fwd2(x))
    r2 = np.asarray(inv2(jnp.asarray(y2)))
    assert np.array_equal(y1, y2)
    assert np.array_equal(r1, r2)
    assert np.array_equal(r2, np.asarray(x))
    assert fwd2.lower(x).as_text().count("all_to_all") == 2
    assert inv2.lower(jnp.asarray(y2)).as_text().count("all_to_all") == 2
