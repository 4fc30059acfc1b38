"""rtrt_tpu — a real-time Monte-Carlo path-tracing framework in JAX, run on
NVIDIA GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the CUDA reference
renderer wangkepfe/Real-Time-Ray-Tracing (see SURVEY.md): per-frame two-level
LBVH rebuild, wavefront 1-spp path tracing with MIS, a physically-based sky,
SVGF-style denoising, and a full post-process chain — all as one fused XLA
program per frame, whose BVH traversal on the GPU is a Pallas/Triton kernel.

Layering (mirrors SURVEY.md §1):
  core/     L0 math & primitives (vecmath, geometry, color, camera)
  ops/      L2 reusable parallel algorithms (morton, sort, scan, stencils)
  bvh/      L3 acceleration-structure engine (build + traversal)
  render/   L4 rendering (raygen, BSDFs, lights, sky, textures, integrator)
  denoise/  L4 SVGF-style temporal + spatial denoising
  post/     L4 post-processing (exposure, bloom, flare, tonemap, sharpen)
  engine/   L5 host runtime (buffers, frame orchestration, public Engine API)
  content/  L6 content generation (terrain, marching cubes, mesh I/O)
  parallel/ multi-chip tile-parallel rendering over a jax.sharding.Mesh
  utils/    config, compile cache, image I/O, debug
  app/      L7 presentation shell (headless CLI + HTTP viewer)
"""

__version__ = "0.1.0"
