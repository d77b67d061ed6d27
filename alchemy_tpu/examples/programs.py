"""The reference's example programs, compiled with pt2ct and ready to run.

One builder per example (Arithmetic, Tunnel, HomomRLWR) at its published
ring, moduli, gadget and Gaussian parameter, returning the compiled program,
its encrypted arguments and the plaintext result the decryption must equal.
The same seed gives the same keys, hints and ciphertexts on every backend,
so an XLA run can be compared bit for bit with a golden (numpy) run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from alchemy_tpu.backend import get_backend
from alchemy_tpu.core.cyc import Cyc
from alchemy_tpu.interp.eval import eval_ir
from alchemy_tpu.interp.keys_hints import KeysHints
from alchemy_tpu.interp.pt2ct import CompiledExpr, pt2ct
from alchemy_tpu.lang.ir import Node
from alchemy_tpu.nt.factor import totient


@dataclass
class Program:
    name: str
    expr: Node                 # the plaintext program
    compiled: CompiledExpr     # its ciphertext program
    ctx: KeysHints             # keys and hints (for decrypt and noise probes)
    args: list                 # encrypted arguments
    want: Cyc                  # plaintext result the decryption must equal

    def eval(self):
        """Evaluate the ciphertext program eagerly on its own backend."""
        return eval_ir(self.compiled.ir, *self.args)


def arithmetic(backend: str = "xla", seed: int = 0) -> Program:
    """addMul = λx y. (x+y)·y over F4 → F512, TrivGad, parameter 3.0."""
    from alchemy_tpu.examples.arithmetic import M, M_MAP, PT, ZP, ZQS, addMul
    from alchemy_tpu.she.gadget import TrivGad

    bk = get_backend(backend)
    rng = np.random.default_rng(seed)
    pt1 = Cyc.from_coeffs(M, (ZP,), rng.integers(0, ZP, totient(M)), bk)
    pt2 = Cyc.from_coeffs(M, (ZP,), rng.integers(0, ZP, totient(M)), bk)
    ctx = KeysHints(3.0, seed=seed, bk=bk)
    compiled = pt2ct(addMul, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(),
                     ctx=ctx)
    args = [compiled.encrypt_arg(pt1, 0), compiled.encrypt_arg(pt2, 1)]
    return Program("arithmetic", addMul, compiled, ctx, args,
                   eval_ir(addMul, pt1, pt2))


def tunnel(backend: str = "xla", seed: int = 1) -> Program:
    """switch3: three ring tunnels H0 → H3, BaseBGad 2, plaintext Z_8."""
    from alchemy_tpu.examples.common import H0, M_MAP, switch
    from alchemy_tpu.examples.tunnel import PT, ZP, ZQS
    from alchemy_tpu.she.gadget import BaseBGad

    bk = get_backend(backend)
    rng = np.random.default_rng(seed)
    expr = switch(3, ZP, backend)
    ctx = KeysHints(3.0, seed=seed, bk=bk)
    compiled = pt2ct(expr, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=BaseBGad(2),
                     ctx=ctx)
    x = Cyc.from_coeffs(H0, (ZP,), rng.integers(0, ZP, totient(H0)), bk)
    return Program("tunnel", expr, compiled, ctx,
                   [compiled.encrypt_arg(x, 0)], eval_ir(expr, x))


def homomrlwr(backend: str = "xla", seed: int = 0) -> Program:
    """ringRound: five tunnels then the depth-5 rescale tree, TrivGad,
    parameter 5.0; the argument is mulPublic a · enc s."""
    from alchemy_tpu.examples.common import H0, M_MAP
    from alchemy_tpu.examples.homomrlwr import PT, ZP_IN, ZQS, ring_round
    from alchemy_tpu.she import bgv
    from alchemy_tpu.she.gadget import TrivGad

    bk = get_backend(backend)
    rng = np.random.default_rng(seed)
    expr = ring_round(backend)
    ctx = KeysHints(5.0, seed=seed, bk=bk)
    compiled = pt2ct(expr, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(),
                     ctx=ctx)
    s = Cyc.from_coeffs(H0, (ZP_IN,), rng.integers(0, ZP_IN, totient(H0)), bk)
    a = Cyc.from_coeffs(H0, (ZP_IN,), rng.integers(0, ZP_IN, totient(H0)), bk)
    ct_sa = bgv.mul_public(a, compiled.encrypt_arg(s, 0))
    return Program("homomrlwr", expr, compiled, ctx, [ct_sa],
                   eval_ir(expr, s * a))


BUILDERS = {"arithmetic": arithmetic, "tunnel": tunnel, "homomrlwr": homomrlwr}
