"""The entry points around the library: compile-cache placement, and
chip_smoke.py / bench.py refusing to run without a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from alchemy_tpu.utils.cache import setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_fixed_in_checkout(monkeypatch):
    import jax

    from alchemy_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.setup_compile_cache() == cache.COMPILE_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == cache.COMPILE_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    for d in (cache.COMPILE_CACHE_DIR, cache.AOT_CACHE_DIR):
        assert os.path.commonpath([d, ROOT]) == ROOT
        rel = os.path.relpath(d, ROOT)
        ignored = subprocess.run(["git", "check-ignore", "-q", rel], cwd=ROOT)
        if ignored.returncode == 128:            # not a git checkout
            pytest.skip("git metadata unavailable")
        assert ignored.returncode == 0, f"{rel} is not git-ignored"


@pytest.mark.parametrize("argv,want", [
    ([], chip_smoke.PHASES),
    (["--four"], chip_smoke.FOUR_PHASES),
])
def test_chip_smoke_phase_selection(argv, want):
    assert chip_smoke.select_phases(argv) == want


def test_chip_smoke_phases_have_runners():
    assert set(chip_smoke.PHASES + chip_smoke.FOUR_PHASES) \
        == set(chip_smoke.RUNNERS)
    with pytest.raises(SystemExit):
        chip_smoke.select_phases(["--bogus"])


def test_chip_smoke_refuses_cpu(capsys):
    """On a CPU-only device list the script prints no result and fails."""
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no GPU" in err


def test_bench_refuses_cpu():
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0 and r.stdout == ""
    assert "no GPU" in r.stderr


def test_negacyclic_mod2_reference():
    """chip_smoke's FFT reference for products mod 2 agrees with a direct
    negacyclic convolution."""
    import numpy as np

    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 2, (2, 3, 64))
    got = chip_smoke.negacyclic_mod2(a, b)
    for i in range(3):
        conv = np.convolve(a[i], b[i])
        want = (conv[:64] + np.concatenate([conv[64:], [0]])) % 2
        assert np.array_equal(got[i], want)


@pytest.mark.gpu
def test_fast_phase_on_gpu():
    """The smoke test's fast-path checks at a small ring, on the card."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX finds none)")
    assert "bit-identical" in chip_smoke.phase_fast(log_n=12, nlimb=4,
                                                    batch=4)
