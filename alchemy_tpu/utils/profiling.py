"""Tracing/profiling utilities (SURVEY.md §5 'tracing/profiling').

The reference's only instrumentation is a wall-clock harness plus the static
introspection interpreters (S/P/Params). Here:
- `phase`: the wall-clock harness (examples/common.py `timed` re-export);
- `trace`: a jax.profiler wrapper producing TensorBoard-readable traces;
- `card_info`: the GPU's name and power limit, as nvidia-smi reports them;
- `cost_table`: the per-op static cost table of a (compiled) expression —
  op COUNTS keyed by (op, modulus-chain annotation), derived from the IR
  (the "per-op cost table from the IR" of SURVEY §5). Data volumes are not
  estimated here; use jax's compiled-cost analysis or the BASELINE.md
  ledger for byte accounting.
"""

from __future__ import annotations

import subprocess
from collections import Counter
from contextlib import contextmanager

from alchemy_tpu.examples.common import timed as phase  # noqa: F401
from alchemy_tpu.lang.ir import App, Lam, Node, Prim, Var


@contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def card_info() -> str:
    """`name, power.limit` of every visible GPU, one line each, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them. Every timing is kept beside this line: a card set below its
    maximum power runs slower under load."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cost_table(expr: Node) -> list[tuple[str, int]]:
    """[(op-with-annotation, count)] over the expression, in descending
    count order. For compiled expressions the annotation carries the
    modulus chain each op runs at."""
    counts: Counter = Counter()

    def walk(node: Node):
        if isinstance(node, Lam):
            walk(node.body)
        elif isinstance(node, App):
            walk(node.f)
            walk(node.a)
        elif isinstance(node, Prim):
            key = node.name
            if node.ann and "zq" in node.ann:
                key = f"{node.name} @ {node.ann['zq']}"
            counts[key] += 1

    walk(expr)
    return counts.most_common()
