"""alchemy_tpu — BGV homomorphic encryption compiled to XLA, with ALCHEMY's
capabilities.

This top-level module re-exports the everyday surface, mirroring the
reference's `Crypto.Alchemy` shim (Crypto/Alchemy.hs:17-25 = Language +
Interpreter + plumbing in one import). See README.md for the full
component-parity table.
"""

from alchemy_tpu.core.cyc import Cyc
from alchemy_tpu.core.params import Modulus, RnsChain
from alchemy_tpu.interp import dup, eval, pprint, size  # noqa: A004
from alchemy_tpu.interp.error_writer import eval_with_error_rates
from alchemy_tpu.interp.keys_hints import KeysHints
from alchemy_tpu.interp.noise import PtTy
from alchemy_tpu.interp.params_print import params
from alchemy_tpu.interp.pt2ct import CompiledExpr, pt2ct
from alchemy_tpu.lang.dsl import compose, lam, lam2, let_
from alchemy_tpu.lang.rescale_tree import rescale_tree_pow2
from alchemy_tpu.she.gadget import BaseBGad, TrivGad
from alchemy_tpu.she.linear import LinearMap

__all__ = [
    "Cyc", "Modulus", "RnsChain",
    "dup", "eval", "pprint", "size", "params",
    "eval_with_error_rates", "KeysHints", "PtTy", "CompiledExpr", "pt2ct",
    "compose", "lam", "lam2", "let_", "rescale_tree_pow2",
    "BaseBGad", "TrivGad", "LinearMap",
]

__version__ = "0.1.0"
