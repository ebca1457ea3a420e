"""fermat_tpu — a differentiable physically-based renderer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of NVlabs/fermat
(reference mounted at /root/reference): wavefront path tracing, bidirectional
path tracing, Metropolis light transport variants, path-space filtering, and
clustered-RL light sampling — as data-parallel JAX programs:

  * traversal + shading run as mega-batched wavefronts (one lane per ray),
  * queue "atomics" are replaced by scan-based stream compaction,
  * framebuffer splats are segment-sums instead of atomic adds,
  * pixel tiles shard over a `jax.sharding.Mesh` with a replicated scene,
  * the whole light-transport loop is differentiable w.r.t. BSDF parameters,
    textures, and emitter radiance.

Layer map (mirrors SURVEY.md §1 for the reference):
  core/        L0/L1: math, RNG, sampling, camera        (cugar basic/linalg/sampling)
  scene/       L4: mesh, materials, lights, loaders      (src/mesh, src/lights...)
  accel/       L2/L3: BVH build + traversal              (cugar/bvh + src/rt.*)
  ops/         Pallas kernels + compaction primitives    (cugar warp_atomics analogs)
  bsdf/        BSDF/EDF models                           (cugar/bsdf + src/bsdf.h)
  integrators/ L6: PT/BPT/MLT engines                    (src/pathtracer_*, bpt_*)
  render/      L5: context, framebuffer, tonemap, denoise (src/renderer.*)
  parallel/    pod sharding (new — no reference analog)
  utils/       image I/O, files, config
"""

__version__ = "0.1.0"
