"""Whole-program XLA compilation of compiled ciphertext expressions.

The reference dispatches each `Cyc` op across the Haskell↔C++ FFI boundary
(SURVEY.md §3.1); the rebuild's eager mode similarly dispatches per op from
Python. `jit_compile` removes that boundary entirely: it traces the compiled
IR's evaluation — every modSwitch, keySwitchQuad, tunnel and ring transform —
into ONE jitted XLA program over the raw ciphertext arrays.

Ciphertext metadata (rings, chains, scales, bases) is static Python state
resolved at trace time. Key-switch/tunnel hints and public plaintexts are
*hoisted into traced arguments* (not baked as HLO constants — hundreds of
megabytes of literal hint rows make XLA constant handling explode).

Requires the XLA backend (golden is numpy). The error-rate-logging mode
(interp/error_writer.py) runs under jit too: pass `noise_probe=ctx` and the
device-resident probe digits (she/noise_probe.py) become auxiliary outputs,
resolved to the reference's [(op ++ modulus, rate)] log after each call.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from alchemy_tpu.core.cyc import Cyc
from alchemy_tpu.interp.eval import eval_ir
from alchemy_tpu.interp.pt2ct import CompiledExpr
from alchemy_tpu.lang.ir import App, Lam, Node, Prim, Var
from alchemy_tpu.she.ct import CT


def _ring(m: int):
    from alchemy_tpu.core.ring import get_ring

    return get_ring(m)


def _cyc_meta(c: Cyc):
    return (c.m, c.qs, c.basis)


def _extract_payload(payload, sink: list):
    """Pull every Cyc's array out of a prim payload into `sink`; return a
    template and a rebuilder closure index map."""
    if isinstance(payload, Cyc):
        sink.append(payload.data)
        return ("cyc", _cyc_meta(payload), len(sink) - 1)
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        fields = {}
        for f in dataclasses.fields(payload):
            fields[f.name] = _extract_payload(getattr(payload, f.name), sink)
        return ("dc", type(payload), fields)
    if isinstance(payload, tuple):
        return ("tuple", tuple(_extract_payload(x, sink) for x in payload))
    if isinstance(payload, list):
        return ("list", [_extract_payload(x, sink) for x in payload])
    return ("raw", payload)


def _rebuild_payload(tmpl, arrays, bk):
    kind = tmpl[0]
    if kind == "cyc":
        _, (m, qs, basis), idx = tmpl
        return Cyc(_ring(m), qs, basis, arrays[idx], bk)
    if kind == "dc":
        _, cls, fields = tmpl
        return cls(**{k: _rebuild_payload(v, arrays, bk) for k, v in fields.items()})
    if kind == "tuple":
        return tuple(_rebuild_payload(x, arrays, bk) for x in tmpl[1])
    if kind == "list":
        return [_rebuild_payload(x, arrays, bk) for x in tmpl[1]]
    return tmpl[1]


#: prims whose payloads carry large device data worth hoisting.
#: addPublic_/mulPublic_ payloads stay baked: they are small plaintext
#: constants that the evaluator lifts host-side (embed_pt) at trace time.
_HOISTED = {"keySwitchQuad_", "tunnel_"}


class ShardingFallbackWarning(UserWarning):
    """An input axis could not be sharded over its mesh axis and was left
    replicated (the silent-replication failure mode of VERDICT r3 #2 — now
    loud). jit_compile's limb padding removes the limb-axis case; a coeff
    axis not divisible by the 'coeff' mesh axis still warns."""


def _auto_sharding(arr, mesh, warn: bool = True):
    """Sharding for a [L, n_flat] ciphertext/hint residue array: limb-TP on
    axis 0 when the chain length divides the 'limb' mesh axis, coefficient-SP
    on the flattened coefficient axis when φ(m') divides the 'coeff' axis
    (every H'-tower ring is divisible by 8); replicated otherwise — with a
    ShardingFallbackWarning, never silently. GSPMD propagates these through
    the whole traced program and inserts the collectives (SURVEY.md
    scaling-book recipe: annotate, let XLA insert)."""
    import warnings

    from jax.sharding import NamedSharding, PartitionSpec as P

    dims = dict(getattr(mesh, "shape", {}))
    l = c = None
    if dims.get("limb", 1) > 1:
        if arr.shape[0] % dims["limb"] == 0:
            l = "limb"
        elif warn and arr.shape[0] > 1:
            warnings.warn(
                f"limb axis of length {arr.shape[0]} not divisible by mesh "
                f"'limb'={dims['limb']}; replicating that axis",
                ShardingFallbackWarning, stacklevel=3)
    if dims.get("coeff", 1) > 1:
        if arr.shape[-1] % dims["coeff"] == 0:
            c = "coeff"
        elif warn:
            warnings.warn(
                f"coefficient axis of length {arr.shape[-1]} not divisible "
                f"by mesh 'coeff'={dims['coeff']}; replicating that axis",
                ShardingFallbackWarning, stacklevel=3)
    return NamedSharding(mesh, P(l, c))


#: AOT export-cache version — bump on any change to the traced evaluator's
#: semantics so stale artifacts never replay
_AOT_CACHE_VERSION = 1

_SRC_FINGERPRINT: str | None = None


def _src_fingerprint() -> str:
    """Hash of every alchemy_tpu source file: the AOT digest must change
    whenever the traced evaluator's CODE changes (a semantically identical
    but faster lowering would otherwise replay the stale artifact and
    silently undo the improvement)."""
    global _SRC_FINGERPRINT
    if _SRC_FINGERPRINT is None:
        import hashlib
        import os as _os

        import alchemy_tpu

        h = hashlib.sha256()
        root = _os.path.dirname(alchemy_tpu.__file__)
        for dirpath, dirnames, filenames in sorted(_os.walk(root)):
            dirnames.sort()
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    path = _os.path.join(dirpath, fn)
                    h.update(fn.encode())
                    with open(path, "rb") as f:
                        h.update(f.read())
        _SRC_FINGERPRINT = h.hexdigest()
    return _SRC_FINGERPRINT


def _payload_sig(payload, h):
    """Feed a stable signature of a prim payload into the hash: Cyc arrays
    by (ring, chain, basis, shape) AND content bytes (baked payloads become
    HLO constants — their values shape the program), everything else by
    repr. Hoisted payloads pass hash_bytes=False at the call site since
    their arrays are traced arguments."""
    if isinstance(payload, Cyc):
        h.update(repr((payload.m, payload.qs, payload.basis)).encode())
        arr = np.asarray(payload.data)
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    elif dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        h.update(type(payload).__name__.encode())
        for f in dataclasses.fields(payload):
            _payload_sig(getattr(payload, f.name), h)
    elif isinstance(payload, (tuple, list)):
        h.update(b"(")
        for x in payload:
            _payload_sig(x, h)
        h.update(b")")
    else:
        h.update(repr(payload).encode())


def _hoisted_sig(tmpl, h):
    """Structure-only signature for hoisted payload templates (arrays are
    traced arguments — only their count/metadata shape the program)."""
    kind = tmpl[0]
    h.update(kind.encode())
    if kind == "cyc":
        h.update(repr(tmpl[1:]).encode())
    elif kind == "dc":
        h.update(tmpl[1].__name__.encode())
        for k, v in tmpl[2].items():
            h.update(k.encode())
            _hoisted_sig(v, h)
    elif kind in ("tuple", "list"):
        for x in tmpl[1]:
            _hoisted_sig(x, h)
    else:
        h.update(repr(tmpl[1]).encode())


class JitCompiled:
    def __init__(self, compiled: CompiledExpr, example_cts: list[CT],
                 mesh=None, limb_pad: bool = True, noise_probe=None,
                 strict: bool = False):
        self.compiled = compiled
        self.mesh = mesh
        self.probe_ctx = noise_probe
        self.probe_strict = strict
        self.arg_meta = [
            (ct.m, ct.zp, ct.scale, [_cyc_meta(c) for c in ct.comps])
            for ct in example_cts
        ]
        self.bk = example_cts[0].bk
        self.aot_loaded = False
        # limb padding: a chain length not divisible by the 'limb' mesh axis
        # cannot be sharded at the jit boundary (JAX rejects uneven input
        # shardings). Pad such arrays with zero rows to the next multiple —
        # sliced back off at trace entry, so semantics are untouched — which
        # lets limb-TP engage on odd chains (e.g. Tunnel's 5-limb ZQS on a
        # 2-way limb axis; VERDICT r3 #2/#3).
        dims = dict(getattr(mesh, "shape", {})) if mesh is not None else {}
        self._limb_div = dims.get("limb", 1) if limb_pad else 1

        # hoist payload arrays out of the IR
        self.const_arrays: list = []
        self._templates: dict[int, tuple] = {}
        self._collect(compiled.ir)
        self._const_rows = [a.shape[0] for a in self.const_arrays]
        self.const_arrays = [self._pad_rows(a) for a in self.const_arrays]
        self._in_rows = [len(qs) for (_, _, _, comps_meta) in self.arg_meta
                         for (_, qs, _) in comps_meta]

        out_box = {}

        def raw(flat_inputs, consts):
            flat_inputs = [a[:r] for a, r in zip(flat_inputs, self._in_rows)]
            consts = [a[:r] for a, r in zip(consts, self._const_rows)]
            cts = []
            i = 0
            for (m, zp, scale, comps_meta) in self.arg_meta:
                comps = []
                for (cm, qs, basis) in comps_meta:
                    comps.append(Cyc(_ring(cm), qs, basis, flat_inputs[i], self.bk))
                    i += 1
                cts.append(CT(m=m, zp=zp, scale=scale, comps=tuple(comps)))
            ir = self._substitute(compiled.ir, consts)
            if self.probe_ctx is not None:
                # strict ERW under whole-program jit (VERDICT r3 #6): the
                # kleislified program's per-op probe digits (device-resident,
                # she/noise_probe.py) become auxiliary jit outputs
                from alchemy_tpu.interp.error_writer import write_error_rates

                out, log = eval_ir(write_error_rates(ir, self.probe_ctx))
                for ct in cts:
                    out, more = out(ct)
                    log = log + more
                out_box["log_meta"] = [(lbl, d.qs) for lbl, d in log]
                probe_outs = tuple(d.digits for _, d in log)
            else:
                out = eval_ir(ir, *cts)
                probe_outs = ()
            out_box["meta"] = (
                out.m, out.zp, out.scale, [_cyc_meta(c) for c in out.comps]
            )
            return tuple(c.data for c in out.comps) + probe_outs

        example_flat = [self._pad_rows(c.data)
                        for ct in example_cts for c in ct.comps]
        self._executable = None

        # AOT export cache (VERDICT r4 #4b): a fresh process repays the
        # whole-IR trace + lower (13.5 s for HomomRLWR) even though the
        # persistent compile cache already covers the XLA compile. The
        # single-device path therefore serializes the jax.export artifact
        # keyed by a digest of the IR (structure + baked payload bytes),
        # argument metadata and jax version; a later process deserializes
        # and replays without tracing the evaluator at all.
        # ALCHEMY_AOT_CACHE=0 disables; any failure falls back silently.
        import os as _os

        from alchemy_tpu.utils.cache import AOT_CACHE_DIR

        aot_dir = _os.environ.get("ALCHEMY_AOT_CACHE", AOT_CACHE_DIR)
        use_aot = aot_dir not in ("", "0") and mesh is None
        aot_path = None
        if use_aot:
            try:
                aot_path = _os.path.join(aot_dir, self._aot_digest() + ".aot")
                if self._try_load_aot(aot_path, example_flat):
                    return
            except Exception:
                aot_path = None

        if mesh is None and aot_path is not None:
            try:
                # export ONCE (the single trace of the evaluator happens
                # inside), run this process through the exported module,
                # and persist the artifact for later processes
                from jax import export as jax_export

                exp = jax_export.export(jax.jit(raw))(
                    example_flat, self.const_arrays)
                self.out_meta = out_box["meta"]
                self.log_meta = out_box.get("log_meta", [])
                self._jitted = jax.jit(lambda fi, c: exp.call(fi, c))
                self.lowered = self._jitted.lower(example_flat,
                                                  self.const_arrays)
                self._save_aot(aot_path, exp)
                return
            except Exception:
                pass  # fall through to the plain jit path

        if mesh is None:
            self._jitted = jax.jit(raw)
        else:
            in_sh = (
                [_auto_sharding(a, mesh) for a in example_flat],
                [_auto_sharding(a, mesh) for a in self.const_arrays],
            )
            self._jitted = jax.jit(raw, in_shardings=in_sh)
        self.lowered = self._jitted.lower(example_flat, self.const_arrays)
        self.out_meta = out_box["meta"]
        self.log_meta = out_box.get("log_meta", [])

    # -- AOT export cache ---------------------------------------------------

    def _aot_digest(self) -> str:
        import hashlib

        h = hashlib.sha256()
        h.update(repr((
            _AOT_CACHE_VERSION, _src_fingerprint(), jax.__version__,
            jax.default_backend(), self.arg_meta, self._limb_div,
            self.probe_strict, self.probe_ctx is not None,
        )).encode())

        def walk(n):
            if isinstance(n, Lam):
                h.update(b"L")
                walk(n.body)
            elif isinstance(n, App):
                h.update(b"A")
                walk(n.f)
                walk(n.a)
            elif isinstance(n, Var):
                h.update(f"V{n.idx}".encode())
            elif isinstance(n, Prim):
                h.update(b"P")
                h.update(n.name.encode())
                if n.uid in self._templates:
                    _hoisted_sig(self._templates[n.uid], h)
                else:
                    _payload_sig(n.payload, h)

        walk(self.compiled.ir)
        return h.hexdigest()

    def _try_load_aot(self, path: str, example_flat) -> bool:
        import os as _os
        import pickle

        if not _os.path.exists(path):
            return False
        try:
            from jax import export as jax_export

            with open(path, "rb") as f:
                blob = pickle.load(f)
            if blob.get("version") != _AOT_CACHE_VERSION:
                return False
            exp = jax_export.deserialize(blob["exported"])
            self._jitted = jax.jit(lambda fi, c: exp.call(fi, c))
            self.aot_loaded = True     # introspection/tests: replayed, no trace
            self.out_meta = blob["out_meta"]
            self.log_meta = blob["log_meta"]
            # introspection attribute stays valid (tracing the one-op
            # call-module wrapper is cheap)
            self.lowered = self._jitted.lower(example_flat,
                                              self.const_arrays)
            return True
        except Exception:
            return False

    def _save_aot(self, path: str, exp) -> None:
        import os as _os
        import pickle
        import tempfile

        try:
            blob = {
                "version": _AOT_CACHE_VERSION,
                "exported": exp.serialize(),
                "out_meta": self.out_meta,
                "log_meta": self.log_meta,
            }
            _os.makedirs(_os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=_os.path.dirname(path))
            with _os.fdopen(fd, "wb") as f:
                pickle.dump(blob, f)
            _os.replace(tmp, path)
        except Exception:
            pass

    @property
    def executable(self):
        """Compiled object for partition-proof inspection (as_text() /
        memory_analysis(); tests/test_jit_exec.py). Built lazily: calls go
        through the jax.jit C++ fastpath instead — Compiled.__call__ pays
        ~2.4 ms of python arg processing PER ARGUMENT, which at the
        examples' hundreds of hoisted hint arrays is ~1000× the actual
        device time (measured 1.18 s vs 15 ms per Tunnel run)."""
        if self._executable is None:
            self._executable = self.lowered.compile()
        return self._executable

    def _pad_rows(self, arr):
        """Zero-pad axis 0 to a multiple of the 'limb' mesh axis (no-op on
        an unmeshed compile or an already-divisible chain)."""
        lp = self._limb_div
        if lp <= 1 or arr.shape[0] % lp == 0:
            return arr
        import jax.numpy as jnp

        pad = [(0, lp - arr.shape[0] % lp)] + [(0, 0)] * (arr.ndim - 1)
        return jnp.pad(arr, pad)

    # ------------------------------------------------------------------

    def _collect(self, node: Node):
        if isinstance(node, Lam):
            self._collect(node.body)
        elif isinstance(node, App):
            self._collect(node.f)
            self._collect(node.a)
        elif isinstance(node, Prim) and node.name in _HOISTED:
            self._templates[node.uid] = _extract_payload(node.payload, self.const_arrays)

    def _substitute(self, node: Node, consts) -> Node:
        if isinstance(node, Lam):
            return Lam(self._substitute(node.body, consts))
        if isinstance(node, App):
            return App(self._substitute(node.f, consts), self._substitute(node.a, consts))
        if isinstance(node, Prim) and node.uid in self._templates:
            payload = _rebuild_payload(self._templates[node.uid], consts, self.bk)
            return Prim(node.name, payload, ann=node.ann)
        if isinstance(node, Var):
            return Var(node.idx)
        return node

    def __call__(self, *cts: CT):
        flat = [self._pad_rows(c.data) for ct in cts for c in ct.comps]
        arrays = self._jitted(flat, self.const_arrays)
        (m, zp, scale, comps_meta) = self.out_meta
        comps = tuple(
            Cyc(_ring(cm), qs, basis, arr, self.bk)
            for (cm, qs, basis), arr in zip(comps_meta, arrays[:len(comps_meta)])
        )
        out = CT(m=m, zp=zp, scale=scale, comps=comps)
        if self.probe_ctx is None:
            return out
        from alchemy_tpu.interp.error_writer import resolve_log
        from alchemy_tpu.she.noise_probe import DeferredRate

        rates = resolve_log(
            [(lbl, DeferredRate(d, qs))
             for (lbl, qs), d in zip(self.log_meta, arrays[len(comps_meta):])],
            strict=self.probe_strict)
        return out, rates


def jit_compile(compiled: CompiledExpr, example_cts: list[CT],
                mesh=None, limb_pad: bool = True,
                noise_probe=None, strict: bool = False) -> JitCompiled:
    """Compile the full ciphertext program into one XLA executable.
    `example_cts` fix the (static) argument metadata.

    With `mesh` (axes 'limb'/'coeff'), the program compiles SPMD-sharded:
    inputs and hoisted hint arrays are annotated limb-TP/coefficient-SP
    (_auto_sharding; odd chain lengths zero-padded to the limb axis so TP
    engages — `limb_pad`) and GSPMD partitions the whole evaluation — the
    sharded execution path for the compiled Tunnel/HomomRLWR programs.
    The `.lowered` attribute exposes the lowering for partition-proof
    inspection (compile().as_text() / memory_analysis()).

    With `noise_probe` (a KeysHints context holding the secret keys), the
    whole program is kleislified (interp/error_writer.py) and every probed
    op's error digits ride along as jit outputs: calls return
    (ct, [(label, rate)]) with zero host lifts. `strict=True` additionally
    raises NoiseOverflowError when a resolved rate crosses the
    decryption-failure threshold. NOTE the abort semantics differ from
    eager eval_with_error_rates(..., strict=True): eager strict aborts at
    the first overflowing op, while the jitted program is one XLA
    executable that runs to completion — the check fires post-hoc in
    resolve_log, after the full result is computed. Same exception, same
    threshold; but a caller that consumes the returned ciphertext BEFORE
    resolving the log bypasses the guard. Resolve (or decrypt via the
    returned pair) before using the output when strict matters."""
    return JitCompiled(compiled, example_cts, mesh=mesh, limb_pad=limb_pad,
                       noise_probe=noise_probe, strict=strict)
