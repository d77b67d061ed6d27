#!/usr/bin/env python
"""On-chip smoke test: the BGV system's main paths, run once on the GPU at
their real sizes and checked bit for bit against the plain references.

    python chip_smoke.py           # one GPU: device, fast, deep, programs
    python chip_smoke.py --four    # four GPUs: device, four (sharded paths)

Phases:
  device    platform, device kind and count, card name and power limit.
  fast      fused mul+relin at n=2^15, L=8, Shoup hints, 16 distinct
            ciphertexts (BASELINE.json configs[4] shape); every product
            decrypts; one matches the native C++ mul+relin in the
            coefficient domain; all NTT formulations agree bit for bit;
            fast.rescale equals hybrid.rescale_joint and decrypts.
  deep      examples/deep_circuit at n=2^15, depth 16, hybrid key switching
            (BASELINE.json configs[3]) in the default formulation, run
            cold then warm.
  programs  Arithmetic, Tunnel and HomomRLWR through pt2ct + jit_compile on
            the xla backend: decrypt equals the plaintext evaluation, the
            output ciphertext equals the golden (numpy) backend's, and
            Tunnel's per-op error rates equal the golden run's.
  four      (--four only) sharded TrivGad and hybrid mul+relin on the
            pick_mesh_shape(4) mesh and GSPMD Tunnel, each bit-identical to
            the single-card result, with per-device input bytes.

Each phase prints one line: PASS or FAIL, its compile (first-call) time, its
steady time and the memory analysis of its main step. The last line of
standard output is one JSON object naming the device, printed only when
every phase passed. Without a GPU the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

SEED = 0
PHASES = ("device", "fast", "deep", "programs")
FOUR_PHASES = ("device", "four")


def select_phases(argv) -> tuple[str, ...]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    return FOUR_PHASES if ap.parse_args(argv).four else PHASES


def _mb(nbytes) -> str:
    return f"{nbytes / 2**20:.1f} MiB"


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"mem args {_mb(m.argument_size_in_bytes)} out "
            f"{_mb(m.output_size_in_bytes)} temp {_mb(m.temp_size_in_bytes)}")


def _steady(step, reps: int = 5) -> float:
    """Seconds per call of `step` (after one warm call), each call ending
    in block_until_ready."""
    import jax

    jax.block_until_ready(step())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(step())
    return (time.perf_counter() - t0) / reps


def _compile_and_time(fn, args):
    """Compile jit(fn) for args, run it once, then time steady calls.
    Returns (out, compile_s, steady_s, memory line)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    return (out, compile_s, _steady(lambda: compiled(*args)),
            _mem(compiled))


def _timing(compile_s, steady_s) -> str:
    return f"compile {compile_s:.2f} s | steady {steady_s * 1e3:.3f} ms"


def negacyclic_mod2(a, b):
    """a·b in Z_2[x]/(x^n + 1) for 0/1 vectors, through a float64 FFT
    (every convolution sum is ≤ n < 2^53, so rounding is exact)."""
    n = a.shape[-1]
    fa = np.fft.rfft(a.astype(np.float64), 2 * n)
    fb = np.fft.rfft(b.astype(np.float64), 2 * n)
    conv = np.rint(np.fft.irfft(fa * fb, 2 * n)).astype(np.int64)
    return (conv[..., :n] + conv[..., n:]) % 2   # x^n = −1 ≡ 1 (mod 2)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(expect_count: int = 1) -> str:
    import jax

    from alchemy_tpu.utils.profiling import card_info

    devs = jax.devices()
    smi = card_info()
    print(smi, flush=True)
    if len(devs) < expect_count:
        raise RuntimeError(f"needs {expect_count} GPUs, found {len(devs)}")
    return (f"{devs[0].platform} {devs[0].device_kind} x{len(devs)} | "
            f"{smi.splitlines()[0]}")


def phase_fast(log_n: int = 15, nlimb: int = 8, batch: int = 16) -> str:
    import jax.numpy as jnp

    from alchemy_tpu import native
    from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
    from alchemy_tpu.nt.primes import root_of_unity
    from alchemy_tpu.she import fast
    from alchemy_tpu.she.fast import IMPLS, FastParams
    from alchemy_tpu.she.hybrid import rescale_joint

    p = FastParams.make(log_n, nlimb, zp=2)
    rng = np.random.default_rng(SEED)
    s = fast.keygen(p, rng)
    hints = fast.relin_hint(p, s, rng, shoup=True)
    ma = rng.integers(0, 2, (batch, p.n))
    mb = rng.integers(0, 2, (batch, p.n))
    ct_a = jnp.stack([fast.encrypt(p, s, m, rng) for m in ma])
    ct_b = jnp.stack([fast.encrypt(p, s, m, rng) for m in mb])

    out, c_s, st_s, mem = _compile_and_time(
        lambda a, b, h: fast.mul_relin(p, a, b, *h), (ct_a, ct_b, hints))
    want = negacyclic_mod2(ma, mb)
    for i in range(batch):
        if not np.array_equal(fast.decrypt(p, s, out[i]), want[i]):
            raise AssertionError(f"ciphertext {i} does not decrypt to a·b")

    # the same product in the coefficient domain, per formulation: inputs
    # and hint values leave p's NTT domain and enter each formulation's
    def coeff(pp, x):
        return np.asarray(fast._intt_p(pp, jnp.asarray(x)))

    ref = coeff(p, out)
    L, n = nlimb, p.n
    # inputs and hint values as one stack of [L, n] polynomials
    polys = coeff(p, jnp.concatenate([
        ct_a.reshape(-1, L, n), ct_b.reshape(-1, L, n), hints[0][0],
        hints[1][0]]))
    a_c, b_c = polys[:2 * batch], polys[2 * batch:4 * batch]
    hb_c, ha_c = polys[4 * batch:4 * batch + L], polys[4 * batch + L:]

    def check_impl(impl):
        pi = FastParams(n=p.n, qs=p.qs, zp=p.zp, impl=impl)
        x = np.asarray(fast._ntt_p(pi, jnp.asarray(polys)))
        got = fast.mul_relin(
            pi, x[:2 * batch].reshape(ct_a.shape),
            x[2 * batch:4 * batch].reshape(ct_b.shape),
            fast.shoup_precompute(x[4 * batch:4 * batch + L], p.qs),
            fast.shoup_precompute(x[4 * batch + L:], p.qs))
        if not np.array_equal(coeff(pi, got), ref):
            raise AssertionError(f"formulation {impl} differs from {p.impl}")

    # each formulation compiles its own programs: compile them side by side
    with ThreadPoolExecutor() as ex:
        list(ex.map(check_impl, [i for i in IMPLS if i != p.impl]))

    def vpu(x):
        return np.asarray(ntt_negacyclic(jnp.asarray(x), p.n, p.qs))

    psis = [root_of_unity(2 * p.n, q) for q in p.qs]
    nat = native.mul_relin(vpu(a_c[:2]), vpu(b_c[:2]), vpu(hb_c),
                           vpu(ha_c), p.qs, psis)
    nat_c = np.asarray(intt_negacyclic(jnp.asarray(nat), p.n, p.qs))
    if not np.array_equal(nat_c, ref[0]):
        raise AssertionError("mul_relin differs from native C++")

    r1 = fast.rescale(p, out, 1)
    rj = rescale_joint(p, out, 1)
    if not np.array_equal(np.asarray(r1), np.asarray(rj)):
        raise AssertionError("fast.rescale differs from rescale_joint")
    p_down = FastParams(n=p.n, qs=p.qs[:-1], zp=p.zp, impl=p.impl)
    for i in range(batch):
        if not np.array_equal(fast.decrypt(p_down, s[:-1], r1[i]), want[i]):
            raise AssertionError(f"rescaled ciphertext {i} fails decrypt")
    return (f"mul_relin n=2^{log_n} L={nlimb} batch={batch} impl={p.impl} | "
            f"{batch}/{batch} decrypt | = native C++ | "
            f"{'='.join(IMPLS)} bit-identical | rescale = rescale_joint | "
            f"{_timing(c_s, st_s)} | {mem}")


def phase_deep(log_n: int = 15, depth: int = 16) -> str:
    """The chain as a user runs it: default formulation, cold then warm."""
    from alchemy_tpu.examples.deep_circuit import run
    from alchemy_tpu.she import fast
    from alchemy_tpu.she.fast import FastParams
    from alchemy_tpu.she.hybrid import (
        HybridKS, hybrid_keygen_hint, mul_relin_hybrid)

    cold, warm = {}, {}
    t0 = time.perf_counter()
    ok, _ = run(log_n=log_n, depth=depth, ks="hybrid", seed=SEED,
                verbose=False, timings=cold)
    cold_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("deep chain does not decrypt")
    t0 = time.perf_counter()
    ok, _ = run(log_n=log_n, depth=depth, ks="hybrid", seed=SEED,
                verbose=False, timings=warm)
    warm_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("deep chain does not decrypt (warm run)")

    # memory of the main step: level 0's hybrid mul+relin
    p = FastParams.make(log_n, depth + 2, zp=2)
    hk = HybridKS.make(p)
    rng = np.random.default_rng(SEED)
    s, hints = hybrid_keygen_hint(hk, rng)
    ct = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    mem = _mem(mul_relin_hybrid.lower(hk, ct, ct, *hints).compile())
    return (f"n=2^{log_n} depth {depth} hybrid impl={p.impl} PASS | cold run "
            f"{cold_s:.1f} s (compile {cold['compile_s']:.1f} s, hints "
            f"{cold['hints_s']:.2f} s, levels {cold['levels_s']:.2f} s) | "
            f"warm run {warm_s:.2f} s (hints {warm['hints_s']:.2f} s, levels "
            f"{warm['levels_s'] * 1e3:.1f} ms) | level-0 {mem}")


def phase_programs(names=("arithmetic", "tunnel", "homomrlwr")) -> str:
    """The programs are built one after another (the DSL's binder counter
    is process-wide), then compile and check concurrently, one thread each;
    steady times are taken afterwards, one program at a time."""
    import jax

    from alchemy_tpu.examples import programs
    from alchemy_tpu.interp.error_writer import eval_with_error_rates
    from alchemy_tpu.interp.jit_exec import jit_compile

    built = {}
    for name in names:
        t0 = time.perf_counter()
        prog = programs.BUILDERS[name]("xla")
        setup_s = time.perf_counter() - t0
        built[name] = (prog, programs.BUILDERS[name]("golden"), setup_s)

    def check(name):
        prog, gold, setup_s = built[name]
        t0 = time.perf_counter()
        jfn = jit_compile(prog.compiled, prog.args)
        out = jfn(*prog.args)
        jax.block_until_ready([c.data for c in out.comps])
        first_s = time.perf_counter() - t0
        if not prog.compiled.decrypt(out).equals(prog.want):
            raise AssertionError(f"{name}: decrypt differs from plaintext")
        g_out = gold.eval()
        for c, g in zip(out.comps, g_out.comps, strict=True):
            if c.m != g.m or not np.array_equal(
                    np.asarray(c.data).astype(np.int64),
                    np.asarray(g.data).astype(np.int64)):
                raise AssertionError(f"{name}: ciphertext differs from golden")
        note = ""
        if name == "tunnel":
            probed = jit_compile(prog.compiled, prog.args,
                                 noise_probe=prog.ctx)
            _, rates = probed(*prog.args)
            _, g_rates = eval_with_error_rates(gold.compiled.ir, gold.ctx,
                                               *gold.args)
            if list(rates) != list(g_rates):
                raise AssertionError(f"tunnel error rates {rates} differ "
                                     f"from golden {g_rates}")
            note = f" ERW {len(rates)} rates = golden,"
        return (f"{name} = golden,{note} set-up {setup_s:.1f} s, first call "
                f"{first_s:.1f} s", jfn, prog.args)

    with ThreadPoolExecutor(len(names)) as ex:
        results = list(ex.map(check, names))
    parts = []
    for line, jfn, args in results:
        steady_s = _steady(lambda: [c.data for c in jfn(*args).comps])
        parts.append(f"{line}, steady {steady_s * 1e3:.2f} ms, "
                     f"{_mem(jfn.executable)}")
    return " | ".join(parts)


def phase_four(log_n: int = 15, nlimb: int = 8, batch: int = 2) -> str:
    """The three sharded checks compile and run concurrently (each in its
    own thread, with its single-card reference); steady times are taken
    afterwards, one check at a time."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from alchemy_tpu.examples import programs
    from alchemy_tpu.interp.jit_exec import jit_compile
    from alchemy_tpu.parallel.dist import (
        DistConfig, from_dist_layout, make_dist_mul_relin,
        make_dist_mul_relin_hybrid, make_dist_ntt, to_dist_layout)
    from alchemy_tpu.parallel.mesh import make_mesh, pick_mesh_shape
    from alchemy_tpu.she import fast
    from alchemy_tpu.she.fast import FastParams
    from alchemy_tpu.she.hybrid import (
        HybridKS, hybrid_relin_hint, mul_relin_hybrid)
    from alchemy_tpu.she.keys import gaussian_coeffs

    devs = jax.devices()[:4]
    shape = pick_mesh_shape(4, nlimb)
    mesh = make_mesh(shape, devs)
    p = FastParams.make(log_n, nlimb, zp=2)
    cfg = DistConfig(p=p, n1=1 << (log_n // 2), n2=p.n >> (log_n // 2))
    hk = HybridKS.make(p)
    cfg_e = DistConfig(p=hk.pe, n1=cfg.n1, n2=cfg.n2)
    rng = np.random.default_rng(SEED)
    s_int = gaussian_coeffs(rng, 1.0, p.n)
    s = fast._ntt_p(p, jnp.asarray(
        np.stack([s_int % q for q in p.qs]).astype(np.uint32)))
    ct_a = jnp.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
                      for _ in range(batch)])
    ct_b = jnp.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
                      for _ in range(batch)])
    trivgad_hints = fast.relin_hint(p, s, rng)
    hybrid_hints = hybrid_relin_hint(hk, s_int, rng)
    fwd, inv = make_dist_ntt(cfg, mesh)
    fwd_e, _ = make_dist_ntt(cfg_e, mesh)
    ct_spec, hint_spec = (P("batch", None, "limb", "coeff"),
                          P(None, "limb", "coeff"))

    def coeff(pp, x):
        return np.asarray(fast._intt_p(pp, x))

    def bridge(pp, c, rows, fwd_c, spec):
        """[..., R, n] in pp's NTT domain → the dist NTT domain, placed on
        the mesh; also the bytes each device holds."""
        d = to_dist_layout(coeff(pp, rows), c)
        flat = np.asarray(fwd_c(jnp.asarray(d.reshape(-1, *d.shape[-2:]))))
        arr = jax.device_put(flat.reshape(d.shape), NamedSharding(mesh, spec))
        per_dev = {sh.device.id: sh.data.nbytes
                   for sh in arr.addressable_shards}
        return arr, per_dev

    def unbridge(out):
        flat = np.asarray(out).reshape(-1, *out.shape[-2:])
        return from_dist_layout(np.asarray(inv(jnp.asarray(flat))),
                                cfg).reshape(out.shape)

    d_a, bytes_a = bridge(p, cfg, ct_a, fwd, ct_spec)
    d_b, _ = bridge(p, cfg, ct_b, fwd, ct_spec)

    def sharded_mul(name, run, want, hints, pp, c, fwd_c):
        d_h = [bridge(pp, c, h, fwd_c, hint_spec) for h in hints]
        args = (d_a, d_b, d_h[0][0], d_h[1][0])
        t0 = time.perf_counter()
        compiled = jax.jit(run).lower(*args).compile()
        compile_s = time.perf_counter() - t0
        if not np.array_equal(unbridge(compiled(*args)), want()):
            raise AssertionError(f"sharded {name} differs from one card")
        return (f"{name} = one card, hint bytes per device {d_h[0][1]}, "
                f"compile {compile_s:.1f} s, {_mem(compiled)}",
                lambda: compiled(*args))

    def check_trivgad():
        return sharded_mul(
            "trivgad mul_relin", make_dist_mul_relin(cfg, mesh),
            lambda: coeff(p, fast.mul_relin(p, ct_a, ct_b, *trivgad_hints)),
            trivgad_hints, p, cfg, fwd)

    def check_hybrid():
        return sharded_mul(
            f"hybrid mul_relin T={len(hk.pe.qs)}",
            make_dist_mul_relin_hybrid(hk, cfg, mesh),
            lambda: coeff(p, mul_relin_hybrid(hk, ct_a, ct_b, *hybrid_hints)),
            hybrid_hints, hk.pe, cfg_e, fwd_e)

    def check_tunnel():
        prog = programs.tunnel("xla")
        single = jit_compile(prog.compiled, prog.args)
        mesh2 = Mesh(np.array(devs).reshape(2, 2), ("limb", "coeff"))
        t0 = time.perf_counter()
        sharded = jit_compile(prog.compiled, prog.args, mesh=mesh2)
        o_sh = sharded(*prog.args)
        jax.block_until_ready([c.data for c in o_sh.comps])
        first_s = time.perf_counter() - t0
        o_1 = single(*prog.args)
        for c1, c2 in zip(o_1.comps, o_sh.comps, strict=True):
            if not np.array_equal(np.asarray(c1.data), np.asarray(c2.data)):
                raise AssertionError("GSPMD Tunnel differs from one card")
        if not prog.compiled.decrypt(o_sh).equals(prog.want):
            raise AssertionError("GSPMD Tunnel does not decrypt")
        a_sh = sharded.executable.memory_analysis().argument_size_in_bytes
        a_1 = single.executable.memory_analysis().argument_size_in_bytes
        return (f"GSPMD tunnel = one card, argument bytes per device "
                f"{_mb(a_sh)} vs {_mb(a_1)} on one card, first call "
                f"{first_s:.1f} s",
                lambda: [c.data for c in sharded(*prog.args).comps])

    with ThreadPoolExecutor(3) as ex:
        futures = [ex.submit(f) for f in (check_trivgad, check_hybrid,
                                          check_tunnel)]
        for f in as_completed(futures):   # each check's line as it passes
            print(f"  four: {f.result()[0]}", flush=True)
        results = [f.result() for f in futures]
    parts = [f"mesh {dict(zip(mesh.axis_names, shape))}",
             f"ct bytes per device {bytes_a} (whole "
             f"{np.asarray(ct_a).nbytes})"]
    for line, step in results:
        parts.append(f"{line}, steady {_steady(step) * 1e3:.3f} ms")
    return " | ".join(parts)


RUNNERS = {"device": phase_device, "fast": phase_fast, "deep": phase_deep,
           "programs": phase_programs, "four": phase_four}


def main(argv=None) -> int:
    phases = select_phases(sys.argv[1:] if argv is None else argv)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX devices: {devs})",
              file=sys.stderr)
        return 1
    from alchemy_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            if name == "device":
                line = phase_device(4 if "four" in phases else 1)
            else:
                line = RUNNERS[name]()
            status = "PASS"
        except Exception as e:   # reported, and the run exits non-zero
            traceback.print_exc()
            line, status = repr(e), "FAIL"
            failed.append(name)
        print(f"phase {name}: {status} | {line} | wall "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
