"""One process of the 2-process multi-host smoke test.

Run via scripts/multihost_smoke.sh — each process owns 4 virtual CPU
devices (pinned to the CPU even on a GPU host, so the two processes never
contend for one card); jax.distributed glues them into one 8-device global
mesh (the recipe a multi-host run uses, scaled down to CPU).

What it proves end-to-end:
  * parallel/distributed.py init_distributed / global_frame_mesh /
    process_frame_slice against a REAL multi-process runtime (not a
    single-process stub),
  * sharded_detect over a cross-process mesh == single-process result,
  * one distributed (psum) BA step over the global mesh == the local
    ba_step, to fp tolerance.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
Writes OK to stdout on success; any assert kills the smoke test.
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from compv_tpu.parallel.distributed import (  # noqa: E402
    global_frame_mesh, init_distributed, process_frame_slice)

init_distributed(coordinator_address=f"localhost:{port}",
                 num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from compv_tpu.parallel.sharded import (  # noqa: E402
    make_distributed_ba_step, sharded_detect)
from compv_tpu.slam.ba import BAConfig, BAProblem, ba_step  # noqa: E402
from tests.fixtures import make_test_image  # noqa: E402

mesh = global_frame_mesh("frame")

# ---- sharded_detect across the 2-process mesh vs local ------------------
n_frames = 8
rs = np.random.default_rng(0)
base = make_test_image(128, 192)
frames_np = np.stack([np.roll(base, 7 * i, axis=1) for i in range(n_frames)])

# per-host IO: each process materializes only its slice, then the global
# array is assembled from process-local shards (the pod ingest pattern)
lo, hi = process_frame_slice(n_frames)
sharding = NamedSharding(mesh, P("frame"))
garr = jax.make_array_from_process_local_data(
    sharding, frames_np[lo:hi], frames_np.shape)

xs, ys, vals, valid, desc = sharded_detect(garr, mesh, threshold=20,
                                           max_features=128)
# outputs stay frame-sharded; each process asserts parity on the frames it
# can address (its local shards) vs a pure-local recompute
from compv_tpu.parallel.sharded import _detect_one  # noqa: E402
want_x, want_y, want_v, want_ok, want_d = jax.vmap(
    lambda im: _detect_one(im, threshold=20, k=128))(jnp.asarray(frames_np))
for shard in vals.addressable_shards:
    f0 = shard.index[0].start or 0
    got = np.asarray(shard.data)
    np.testing.assert_array_equal(got, np.asarray(want_v)[f0: f0 + len(got)])
print(f"[p{pid}] sharded_detect parity ok", flush=True)

# ---- one distributed BA step vs local -----------------------------------
F, L, O = 16, 256, 4096
cams = rs.normal(0, 0.1, (F, 6)).astype(np.float32)
lms = (rs.normal(0, 1.0, (L, 3)) + [0, 0, 5]).astype(np.float32)
intr = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
ci = rs.integers(0, F, O).astype(np.int32)
li = rs.integers(0, L, O).astype(np.int32)
uv = (rs.normal(0, 50, (O, 2)) + [320, 240]).astype(np.float32)
ok = np.ones(O, bool)

local_prob = BAProblem(jnp.asarray(cams), jnp.asarray(lms),
                       jnp.asarray(intr), jnp.asarray(ci), jnp.asarray(li),
                       jnp.asarray(uv), jnp.asarray(ok))
cfg = BAConfig(cg_iterations=8)
want_prob, _, _ = ba_step(local_prob, jnp.float32(1e-3), cfg)

step = make_distributed_ba_step(mesh, cfg)
# shard observations across the global mesh (obs axis), replicate states
rep = NamedSharding(mesh, P())
obs_sh = NamedSharding(mesh, P("frame"))
dist_prob = BAProblem(
    jax.device_put(jnp.asarray(cams), rep),
    jax.device_put(jnp.asarray(lms), rep),
    jax.device_put(jnp.asarray(intr), rep),
    jax.device_put(jnp.asarray(ci), obs_sh),
    jax.device_put(jnp.asarray(li), obs_sh),
    jax.device_put(jnp.asarray(uv), obs_sh),
    jax.device_put(jnp.asarray(ok), obs_sh))
got_prob, _, _ = step(dist_prob, jnp.float32(1e-3))
# cameras/landmarks are replicated (P()) -> addressable on every process
got_cams = np.asarray(got_prob.cameras.addressable_shards[0].data)
got_lms = np.asarray(got_prob.landmarks.addressable_shards[0].data)
np.testing.assert_allclose(got_cams, np.asarray(want_prob.cameras),
                           atol=2e-4)
np.testing.assert_allclose(got_lms, np.asarray(want_prob.landmarks),
                           atol=2e-4)
print(f"[p{pid}] distributed BA step parity ok", flush=True)
print(f"[p{pid}] OK", flush=True)
