"""webgl_raytracer_tpu_torch — the PyTorch/CUDA port of webgl_raytracer_tpu.

The JAX package beside it is the reference; this package renders the same
scenes with the same transport and the same PCG sample stream on an
NVIDIA GPU, its ray traversal in hand-written CUDA kernels for Hopper
(csrc/). It imports torch, never jax and nothing of the JAX package.
Layout mirrors the reference:

  models/  molecule parsing (SDF, PDB), bond inference, ball-and-stick
           geometry, triangle meshes and the protein cartoon (host numpy)
  app/     scene-loading pipelines (display styles, the cartoon scene, the
           debug and random-sphere scenes), the CLI (render / bench / pick
           / info / serve) and the HTTP viewer
  scene/   host-side BVH build, cluster compile, camera maths, the CPU
           picking tracer and the hover overlay
  env/     HDR codec, analytic sky, environment CDFs and controller
  ops/     RNG, vector/sampling/BRDF maths, env-map sampling, tone map,
           the cluster tracer and its kernels (ops/trace.py, ops/kernels.py)
  render/  settings split, the path-tracing integrator, the Renderer,
           picking through its camera, and the reference oracle (numpy
           transliteration of the shader, its all-pairs trace optionally
           on the card)
  parallel/ the tile mesh: scene copied to every card, each frame's rays
           split into one shard a card (Renderer(mesh=...), --devices N),
           samples split by render_spp_sharded
  tools/   the sweep-rate probe and the parity tool (renderer vs oracle)
  utils/   the ring logger, display formatting, the stdlib PNG codec
  csrc/    CUDA sources of the kernels, and the C++ BVH builder

Entry points put their tensors on cuda:0 unless given device="cpu".
"""

__version__ = "0.1.0"
