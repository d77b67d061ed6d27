"""Array backends for the ring layer.

- `golden`: exact numpy int64 arithmetic — the oracle every other backend must
  match limb-for-limb (replaces the reference's Lol/lol-cpp as the semantics
  pin, SURVEY.md §7 step 1).
- `xla`: jnp uint32 lane arithmetic (Shoup / split-Barrett), jit-able, runs on
  the CPU and the GPU; bit-identical to golden.
- `checked`: runs every op on xla and golden and asserts bit-identity.

Note: accessors are named *_backend to avoid colliding with the submodule
attributes Python sets on the package when the submodules are imported.
"""

_GOLDEN = None
_XLA = None


def golden_backend():
    global _GOLDEN
    if _GOLDEN is None:
        from alchemy_tpu.backend.golden import GoldenBackend

        _GOLDEN = GoldenBackend()
    return _GOLDEN


def xla_backend():
    global _XLA
    if _XLA is None:
        from alchemy_tpu.backend.xla import XlaBackend

        _XLA = XlaBackend()
    return _XLA


_CHECKED = None


def checked_backend():
    global _CHECKED
    if _CHECKED is None:
        from alchemy_tpu.backend.checked import CheckedBackend

        _CHECKED = CheckedBackend()
    return _CHECKED


def get_backend(name: str):
    if name == "golden":
        return golden_backend()
    if name == "xla":
        return xla_backend()
    if name == "checked":
        return checked_backend()
    raise ValueError(f"unknown backend {name!r}")
