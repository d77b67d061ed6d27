#!/usr/bin/env python
"""Reusable device-time profiler: runs a jitted step under
jax.profiler.trace and aggregates per-op device time from the trace events.

Library use:
    from profile_trace import profile_step
    events = profile_step(step_fn, args, iters=20)
    # events: list of (op_name, total_us, count) sorted by time desc

CLI: python scripts/profile_trace.py  (profiles the north-star op: fused
mul+relin at 2^15, L=8, batch 16 of distinct ciphertexts; env PROF_LOG_N,
PROF_NLIMB, PROF_BATCH, PROF_ITERS).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def _parse_trace(tdir):
    """Aggregate device-lane events from the chrome trace file."""
    paths = glob.glob(os.path.join(tdir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no trace.json.gz under {tdir}")
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    # device lanes: pid whose process_name metadata mentions the device
    dev_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = e.get("args", {}).get("name", "")
            if any(k in name.lower() for k in ("gpu", "device", "xla")):
                if "host" not in name.lower():
                    dev_pids.add(e["pid"])
    agg: dict[str, list[float]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))
        agg.setdefault(name, []).append(dur)
    out = [(k, sum(v), len(v)) for k, v in agg.items()]
    out.sort(key=lambda t: -t[1])
    return out


def profile_step(step, args=(), iters: int = 20, tdir: str | None = None):
    """Run `step(*args)` iters times under the profiler; return aggregated
    device events [(name, total_us, count)] over the whole traced span.
    Divide totals by `iters` for per-step time. The step should be jitted
    and already warmed (compiled) by the caller."""
    import jax

    own = tdir is None
    if own:
        tdir = tempfile.mkdtemp(prefix="alchemy_prof_")
    with jax.profiler.trace(tdir):
        out = None
        for _ in range(iters):
            out = step(*args)
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready() if hasattr(
                x, "block_until_ready") else x, out)
    return _parse_trace(tdir)


def print_events(events, iters: int, top: int = 25):
    total = sum(t for _, t, _ in events)
    print(f"{'per-step us':>12} {'count':>6} {'%':>6}  op")
    for name, tot, cnt in events[:top]:
        print(f"{tot/iters:12.1f} {cnt:6d} {100*tot/total:6.1f}  {name[:90]}")
    print(f"{total/iters:12.1f} {'':6} {'':6}  TOTAL device")


def main():
    import jax
    import jax.numpy as jnp

    from functools import partial

    from alchemy_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()

    from alchemy_tpu.she import fast
    from alchemy_tpu.she.fast import FastParams

    log_n = int(os.environ.get("PROF_LOG_N", "15"))
    nlimb = int(os.environ.get("PROF_NLIMB", "8"))
    batch = int(os.environ.get("PROF_BATCH", "16"))
    iters = int(os.environ.get("PROF_ITERS", "20"))
    p = FastParams.make(log_n, nlimb, zp=2)
    rng = np.random.default_rng(0)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)

    def cts():
        return jnp.stack([fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
                          for _ in range(batch)])

    ct1, ct2 = cts(), cts()
    print(f"{jax.devices()[0].device_kind} | mul_relin n=2^{log_n} "
          f"L={nlimb} batch={batch} impl={p.impl}", flush=True)

    @partial(jax.jit, static_argnums=0)
    def step(pp, a, b, h0, h1):
        return fast.mul_relin(pp, a, b, h0, h1)

    out = step(p, ct1, ct2, hb, ha)
    out.block_until_ready()
    events = profile_step(step, (p, ct1, ct2, hb, ha), iters=iters)
    print_events(events, iters)


if __name__ == "__main__":
    main()
