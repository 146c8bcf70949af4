"""Distributed SfM demo: sharded per-frame detection, cross-shard descriptor
matching, and a distributed BA solve on the device mesh (BASELINE config 5).

Runs on every device of JAX's default backend: all the GPUs of the host,
or, with JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8,
a virtual 8-device CPU mesh.
"""
import numpy as np

from common import textured_scene

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from compv_tpu.parallel.mesh import make_mesh
from compv_tpu.parallel.sharded import (
    distributed_ba_solve, sharded_all_pairs_match, sharded_detect,
)
from compv_tpu.slam.ba import BAConfig, BAProblem, reproj_rmse


def main():
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} devices")

    # --- sharded frontend over a frame batch
    rs = np.random.default_rng(0)
    frames = np.stack([np.roll(textured_scene(96, 128), 3 * i, axis=1)
                       for i in range(2 * n_dev)])
    imgs = jax.device_put(jnp.asarray(frames), NamedSharding(mesh, P("frame")))
    x, y, s, valid, desc = sharded_detect(imgs, mesh, max_features=64)
    sim = np.asarray(sharded_all_pairs_match(desc, valid, mesh))
    print("frame-similarity matrix (mean min-hamming), first row:",
          np.round(sim[0, :6], 1))

    # --- distributed BA on a synthetic scene
    n_cams, n_lms = 6, 48
    lms = rs.uniform(-1, 1, (n_lms, 3)) + [0, 0, 5.0]
    cams = np.zeros((n_cams, 6))
    cams[:, 3] = np.linspace(-1, 1, n_cams)
    intr = np.array([300.0, 300.0, 64.0, 48.0])
    ci = np.repeat(np.arange(n_cams), n_lms).astype(np.int32)
    li = np.tile(np.arange(n_lms), n_cams).astype(np.int32)
    # exact observations from ground truth, then perturb the initial state
    from compv_tpu.slam.ba import project_points
    uv = np.asarray(project_points(
        jnp.asarray(cams, jnp.float32), jnp.asarray(lms, jnp.float32),
        jnp.asarray(intr, jnp.float32), jnp.asarray(ci), jnp.asarray(li)))
    cams_n = cams + rs.normal(0, 0.01, cams.shape)
    cams_n[0] = cams[0]
    lms_n = lms + rs.normal(0, 0.02, lms.shape)

    n_obs = (len(ci) // n_dev) * n_dev
    shard = NamedSharding(mesh, P("frame"))
    repl = NamedSharding(mesh, P())
    prob = BAProblem(
        cameras=jax.device_put(jnp.asarray(cams_n, jnp.float32), repl),
        landmarks=jax.device_put(jnp.asarray(lms_n, jnp.float32), repl),
        intrinsics=jax.device_put(jnp.asarray(intr, jnp.float32), repl),
        cam_idx=jax.device_put(jnp.asarray(ci[:n_obs]), shard),
        lm_idx=jax.device_put(jnp.asarray(li[:n_obs]), shard),
        uv=jax.device_put(jnp.asarray(uv[:n_obs], jnp.float32), shard),
        valid=jax.device_put(jnp.ones(n_obs, bool), shard),
    )
    print(f"reproj RMSE before BA: {float(reproj_rmse(prob)):.3f} px")
    solved, cost = distributed_ba_solve(prob, mesh, BAConfig(iterations=8,
                                                             cg_iterations=25))
    print(f"reproj RMSE after distributed BA: {float(reproj_rmse(solved)):.3f} px")


if __name__ == "__main__":
    main()
