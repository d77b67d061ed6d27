import os

# Multi-device CPU mesh for the sharding tests. Tests that need the GPU are
# marked `gpu` and decide inside the test whether a card is present; run
# them on a GPU machine with JAX_PLATFORMS=cuda python -m pytest -m gpu.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
