"""Worker for tests/test_multihost.py: one of two jax.distributed CPU
processes running the coefficient-sharded distributed NTT with the 'coeff'
mesh axis spanning the PROCESS boundary (the DCN analog — SURVEY.md §2.4
communication backend; same shard_map program as single-process).

Usage: python multihost_worker.py <pid> <nproc> <port>
Prints "WORKER_OK" on success; any assertion failure exits nonzero.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from alchemy_tpu.parallel.multihost import init_multihost  # noqa: E402

ndev = init_multihost(f"127.0.0.1:{port}", nproc, pid, cpu_collectives="gloo")
assert ndev == nproc, ndev
assert jax.process_count() == nproc

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic  # noqa: E402
from alchemy_tpu.backend.xla import mulmod  # noqa: E402
from alchemy_tpu.parallel.dist import DistConfig, make_dist_ntt  # noqa: E402
from alchemy_tpu.parallel.mesh import make_mesh  # noqa: E402
from alchemy_tpu.she.fast import FastParams  # noqa: E402

B, log_n, nlimb = 2, 6, 2
p = FastParams.make(log_n, nlimb, zp=2)
n1 = 8
cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
mesh = make_mesh((1, 1, nproc))  # ('batch','limb','coeff'); coeff crosses procs

rng = np.random.default_rng(0)  # same stream in every process
a = rng.integers(0, min(p.qs), p.n)
b = rng.integers(0, min(p.qs), p.n)


def to_dist_layout(coeffs):
    idx = np.empty(p.n, dtype=np.int64)
    for j2 in range(cfg.n2):
        for j1 in range(cfg.n1):
            idx[j2 * n1 + j1] = j1 * cfg.n2 + j2
    return coeffs[..., idx]


def from_dist_layout(stored):
    idx = np.empty(p.n, dtype=np.int64)
    for j2 in range(cfg.n2):
        for j1 in range(cfg.n1):
            idx[j1 * cfg.n2 + j2] = j2 * n1 + j1
    return stored[..., idx]


def global_arr(host_np):
    """Every process holds the full numpy value; build the sharded global
    jax.Array by serving each device its slice."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(None, None, "coeff"))
    return jax.make_array_from_callback(host_np.shape, sh,
                                        lambda idx: host_np[idx])


def host_stack(v):
    res = np.stack([v % q for q in p.qs]).astype(np.uint32)
    stored = to_dist_layout(res)
    return np.stack([stored] * B)  # [B, L, n]


fwd, inv = make_dist_ntt(cfg, mesh)

xa, xb = global_arr(host_stack(a)), global_arr(host_stack(b))

# 1. roundtrip across the process boundary
rt = inv(fwd(xa))
for shard in rt.addressable_shards:
    want = host_stack(a)[shard.index]
    assert np.array_equal(np.asarray(shard.data), want), "roundtrip mismatch"

# 2. pointwise mul in the sharded NTT domain == negacyclic ring mul
fa, fb = fwd(xa), fwd(xb)
prod = inv(mulmod(fa, fb, p.qs))
na = ntt_negacyclic(jnp.asarray(np.stack([a % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
nb = ntt_negacyclic(jnp.asarray(np.stack([b % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
ref = np.asarray(intt_negacyclic(mulmod(na, nb, p.qs), p.n, p.qs))
want_full = np.stack([to_dist_layout(ref)] * B)
for shard in prod.addressable_shards:
    assert np.array_equal(np.asarray(shard.data), want_full[shard.index]), \
        "sharded ring mul mismatch"

# 3. fused mul+relin with the 'limb' axis spanning the PROCESS boundary:
# the relinearization all_gather of c2 rows crosses DCN-analog transport.
# Reference computed locally per process with the single-chip fast path.
from alchemy_tpu.parallel.dist import make_dist_mul_relin  # noqa: E402
from alchemy_tpu.she import fast  # noqa: E402

mesh_l = make_mesh((1, nproc, 1))  # 'limb' across processes
fwd_l, inv_l = make_dist_ntt(cfg, mesh_l)
run_l = make_dist_mul_relin(cfg, mesh_l)

s_key = fast.keygen(p, np.random.default_rng(1))
hbf, haf = fast.relin_hint(p, s_key, np.random.default_rng(2))
ct1 = fast.encrypt(p, s_key, rng.integers(0, 2, p.n), np.random.default_rng(3))
ct2 = fast.encrypt(p, s_key, rng.integers(0, 2, p.n), np.random.default_rng(4))
want = fast.mul_relin(p, ct1, ct2, hbf, haf)
want_coeff = np.asarray(intt_negacyclic(want, p.n, p.qs))


def global_arr_l(host_np, spec_limb_axis):
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = [None] * host_np.ndim
    axes[spec_limb_axis] = "limb"
    sh = NamedSharding(mesh_l, P(*axes))
    return jax.make_array_from_callback(host_np.shape, sh,
                                        lambda idx: host_np[idx])


from jax.experimental import multihost_utils  # noqa: E402


def to_host(garr):
    """Full value of a cross-process global array on every process."""
    return np.asarray(multihost_utils.process_allgather(garr, tiled=True))


def bridge_rows(rows):
    """[K, L, n] fast-NTT-domain rows → dist NTT domain on mesh_l."""
    coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, p.qs))
    stored = to_dist_layout(coeff)
    return to_host(fwd_l(global_arr_l(stored, 1)))


L = len(p.qs)
d_cts = bridge_rows(np.concatenate(
    [np.asarray(ct1), np.asarray(ct2)], axis=0)).reshape(2, 2, L, p.n)
d_hb = bridge_rows(np.stack([np.asarray(hbf[i]) for i in range(L)]))
d_ha = bridge_rows(np.stack([np.asarray(haf[i]) for i in range(L)]))

ct_in1 = global_arr_l(np.stack([d_cts[0]] * B), 2)   # [B, 2, L, n]
ct_in2 = global_arr_l(np.stack([d_cts[1]] * B), 2)
out = run_l(ct_in1, ct_in2, global_arr_l(d_hb, 1), global_arr_l(d_ha, 1))
got = to_host(inv_l(global_arr_l(
    to_host(out).reshape(2 * B, L, p.n), 1)))
got = from_dist_layout(got).reshape(B, 2, L, p.n)
for bi in range(B):
    assert np.array_equal(got[bi], want_coeff), "cross-process mul_relin"

print("WORKER_OK", flush=True)
