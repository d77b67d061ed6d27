"""ERW — error-rate writer (reference Interpreter/ErrorRateWriter.hs).

The reference rewrites the object program into a *Kleisli* program over an
object-language writer monad: every arrow `a -> b` becomes `a -> w b`
(`Kleislify`, ErrorRateWriter.hs:45-49) and every ciphertext-producing op
gains a `tellError` step logging `(opName ++ modulus, errorRate)`
(ErrorRateWriter.hs:70-75, 85-106). `write_error_rates` is that same
IR → IR transform: the result is an ordinary object program built from the
Monad symantics (pure_/bind_/tell_, Language/Monad.hs) plus a `tellError`
probe primitive, so it can be evaluated, pretty-printed, and sized like any
other term; evaluating it under the structural writer monad of interp/eval
yields (value, ErrorRateLog). Keys come from the KeysHints context (the
reference reads them via readerToAccumulator, MonadAccumulator.hs:80-82).

`eval_with_error_rates` = transform + eval (the reference's
`runWriter $ eval (writeErrorRates term) >>= ...` usage,
examples/Arithmetic.hs:67-68).
"""

from __future__ import annotations

from alchemy_tpu.interp.eval import eval_ir as _eval
from alchemy_tpu.interp.keys_hints import KeysHints
from alchemy_tpu.lang.ir import App, Lam, Node, Prim, Var

#: ops that produce ciphertexts and are probed (ErrorRateWriter.hs:108-198)
_PROBED = {
    "add_", "neg_", "mul_", "addLit_", "mulLit_", "div2_",
    "modSwitchPT_", "modSwitch_", "addPublic_", "mulPublic_",
    "keySwitchQuad_", "tunnel_",
}

#: curried arity of every primitive a source program may contain
_ARITY = {
    "add_": 2, "mul_": 2, "pair_": 2, "cons_": 2,
    "neg_": 1, "div2_": 1, "addLit_": 1, "mulLit_": 1, "linearCyc_": 1,
    "modSwitchPT_": 1, "modSwitch_": 1, "addPublic_": 1, "mulPublic_": 1,
    "keySwitchQuad_": 1, "tunnel_": 1, "errorRate_": 1,
    "fst_": 1, "snd_": 1,
    "nil_": 0, "string_": 0,
}

#: error rate above which decryption failure is imminent (reference
#: observation, SURVEY.md §4 item 4: rates approaching ~0.25-0.5 fail)
NOISE_OVERFLOW_THRESHOLD = 0.25


class NoiseOverflowError(RuntimeError):
    """Raised in strict mode when a ciphertext's error rate crosses the
    decryption-failure threshold (the runtime analog of the reference's
    compile-time modulus-exhaustion TypeError)."""


def _pure(t: Node) -> Node:
    return App(Prim("pure_", "writer"), t)


def _bind(ma: Node, k: Node) -> Node:
    return App(App(Prim("bind_", "writer"), ma), k)


def _shift(node: Node, by: int, cutoff: int = 0) -> Node:
    """Standard de Bruijn shift of free variables ≥ cutoff."""
    if isinstance(node, Var):
        return Var(node.idx + by) if node.idx >= cutoff else node
    if isinstance(node, Lam):
        return Lam(_shift(node.body, by, cutoff + 1))
    if isinstance(node, App):
        return App(_shift(node.f, by, cutoff), _shift(node.a, by, cutoff))
    return node


def _probe_wrap(res: Node, name: str, ctx: KeysHints, strict: bool) -> Node:
    """`res >>= \\y -> tell (tellError y) >> pure y` — the `after_ tellError`
    composition of ErrorRateWriter.hs:92-97 as an object term."""
    entries = App(Prim("tellEntries_", (name, ctx, strict)), Var(0))
    tell = App(Prim("tell_", "writer"), entries)
    return _bind(_pure(res), Lam(_bind(tell, Lam(_pure(Var(1))))))


def _kleisli_prim(node: Prim, ctx: KeysHints, strict: bool) -> Node:
    name = node.name
    if name not in _ARITY:
        raise ValueError(f"writeErrorRates: primitive {name!r} not Kleislifiable")
    arity = _ARITY[name]
    if arity == 0:
        return _pure(node)
    probed = name in _PROBED

    def wrap(res: Node) -> Node:
        return _probe_wrap(res, name, ctx, strict) if probed else _pure(res)

    if arity == 1:
        return _pure(Lam(wrap(App(node, Var(0)))))
    return _pure(Lam(_pure(Lam(wrap(App(App(node, Var(1)), Var(0)))))))


def write_error_rates(expr: Node, ctx: KeysHints, strict: bool = False) -> Node:
    """Kleislify `expr`: the returned term is writer-monadic (`w a`; arrows
    become `a -> w b`), logging per-op error rates as it runs — the
    reference's `writeErrorRates` (ErrorRateWriter.hs:55-57)."""

    def go(node: Node) -> Node:
        if isinstance(node, Var):
            return _pure(node)
        if isinstance(node, Lam):
            return _pure(Lam(go(node.body)))
        if isinstance(node, App):
            tf = go(node.f)
            ta = _shift(go(node.a), 1)
            # f' <- tf; a' <- ta; f' a'   (ERW's Lambda_ `$:` instance)
            return _bind(tf, Lam(_bind(ta, Lam(App(Var(1), Var(0))))))
        if isinstance(node, Prim):
            return _kleisli_prim(node, ctx, strict)
        raise TypeError(node)

    return go(expr)


def resolve_log(log, strict: bool = False) -> list:
    """Resolve any DeferredRate entries (device-probe digit vectors produced
    under a jit trace, she/noise_probe.py) to floats, applying the strict
    overflow check that eager probes perform inline.

    All deferred digit vectors are fetched in ONE device→host transfer
    (jax.device_get of the list) instead of one readback per entry."""
    import jax

    from alchemy_tpu.she.noise_probe import DeferredRate, rate_from_digits

    deferred = [(i, r) for i, (_, r) in enumerate(log)
                if isinstance(r, DeferredRate)]
    fetched = jax.device_get([r.digits for _, r in deferred]) \
        if deferred else []
    resolved = {i: rate_from_digits(d, r.qs)
                for (i, r), d in zip(deferred, fetched)}
    out = []
    for i, (label, rate) in enumerate(log):
        if i in resolved:
            rate = resolved[i]
            if strict and rate > NOISE_OVERFLOW_THRESHOLD:
                raise NoiseOverflowError(
                    f"{label}: error rate {rate:.3g} exceeds "
                    f"{NOISE_OVERFLOW_THRESHOLD}")
        out.append((label, rate))
    return out


def eval_with_error_rates(expr: Node, ctx: KeysHints, *args, strict: bool = False):
    """Evaluate a (compiled) expression under the writer monad, returning
    (result, error_rate_log) with the reference's ErrorRateLog format
    [(op ++ modulus, rate)]. strict=True raises NoiseOverflowError when a
    rate crosses the decryption-failure threshold. On the xla backend the
    per-op probe runs on device (she/noise_probe.py) with only an [L]
    digit-vector readback per op."""
    v, log = _eval(write_error_rates(expr, ctx, strict))
    for a in args:
        v, more = v(a)
        log = log + more
    return v, resolve_log(list(log), strict)
