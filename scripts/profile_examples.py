#!/usr/bin/env python
"""Device-time breakdown for the general-cyclotomic example workloads.

For Tunnel and HomomRLWR (the reference's shipped workloads,
alchemy.cabal:81-123), this script:
  1. builds the whole-program jitted step (interp/jit_exec.py),
  2. counts the EXACT base MACs of every merged-axis CRT transform at
     trace time (backend/xla.MAC_COUNTER hook on axis_matmul),
  3. profiles per-op device time (jax.profiler via profile_trace.py) and
     buckets it into compute (dots/fusions) vs data movement
     (copy/reshape/transpose/bitcast).

Run from the repo root: python scripts/profile_examples.py
Prints one JSON record per workload. Env: EXP_ITERS (default 30), EXP_ONLY
(tunnel|homomrlwr).
"""

from __future__ import annotations

import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

from alchemy_tpu.utils.cache import setup_compile_cache

setup_compile_cache()


def _build(name):
    from alchemy_tpu.examples import programs
    from alchemy_tpu.interp.jit_exec import jit_compile

    prog = programs.BUILDERS[name]("xla")
    return jit_compile(prog.compiled, prog.args), prog.args


MOVE_KEYS = ("copy", "reshape", "transpose", "bitcast", "slice", "dynamic")


def profile_one(name, iters):
    from alchemy_tpu.backend import xla as xla_mod
    from profile_trace import profile_step

    # exact MAC ledger: the evaluator traces inside jit_compile (and the
    # AOT cache would skip tracing entirely) — enable counting around the
    # BUILD and force a real trace
    os.environ["ALCHEMY_AOT_CACHE"] = "0"
    xla_mod.MAC_COUNTER = []
    jfn, args = _build(name)
    t0 = time.perf_counter()
    out = jfn(*args)
    for c in out.comps:
        c.data.block_until_ready()
    compile_s = time.perf_counter() - t0
    macs_rec = list(xla_mod.MAC_COUNTER)
    xla_mod.MAC_COUNTER = None
    base_macs = sum(L * di * do * R for (L, di, do, R) in macs_rec)

    def step():
        return jfn(*args)

    events = profile_step(step, (), iters=iters)
    # drop the outer jit region (it double-counts its children)
    inner = [e for e in events if not e[0].startswith("jit_")]
    total_us = sum(t for _, t, _ in inner) / iters
    move_us = sum(t for n, t, _ in inner
                  if any(k in n.lower() for k in MOVE_KEYS)) / iters
    comp_us = total_us - move_us
    n_ops = sum(c for _, _, c in inner) / iters
    top = [{"op": n[:80], "us_per_step": round(t / iters, 1),
            "count_per_step": round(c / iters, 1)}
           for n, t, c in inner[:12]]
    return {
        "workload": name,
        "device_us_per_step": round(total_us, 1),
        "data_movement_us": round(move_us, 1),
        "compute_us": round(comp_us, 1),
        "data_movement_pct": round(100 * move_us / total_us, 1),
        "device_ops_per_step": int(n_ops),
        "transform_groups_per_step": len(macs_rec),
        "exact_base_macs_per_step": int(base_macs),
        "trace_compile_s": round(compile_s, 1),
        "top_ops": top,
    }


def main():
    import jax

    iters = int(os.environ.get("EXP_ITERS", "30"))
    only = os.environ.get("EXP_ONLY", "")
    for name in ("tunnel", "homomrlwr"):
        if only in ("", name):
            rec = profile_one(name, iters)
            rec["device_kind"] = jax.devices()[0].device_kind
            print(json.dumps(rec, indent=1), flush=True)


if __name__ == "__main__":
    main()
