"""grav1synth: an AV1 film-grain engine on JAX.

A ground-up JAX/XLA/Pallas framework with the capabilities of
rust-av/grav1synth (reference: /root/reference):

- ``inspect``  — extract per-frame film_grain_params into a filmgrn1 table
- ``apply``    — splice grain parameters from a table into an AV1 bitstream
- ``generate`` — synthesize photon-noise grain parameters from an ISO value
- ``remove``   — strip all grain synthesis from a bitstream
- ``diff``     — estimate a grain table from a grainy/denoised source pair

plus what the reference delegates to playback decoders: the AV1 spec
grain-synthesis loop itself (LFSR noise, AR pattern, scaling LUT, 32x32
block blend with overlap) as JAX device code -- Pallas kernels on an
NVIDIA GPU, plain XLA elsewhere -- bit-exact vs dav1d, with frame/GOP
sharding over a `jax.sharding.Mesh` across devices and hosts.

Layering (bottom-up):
  bitio      -- bit-level primitives (leb128/uvlc/ns/su), host code
  obu        -- AV1 syntax codec: parse + surgical bit-splice rewrite
  container  -- IVF (pure) + libavformat/libavcodec native shim (C++)
  ops        -- grain math on device: synthesis kernels, photon noise,
                diff estimation (JAX + Pallas)
  tables     -- filmgrn1 interchange format + segment aggregation
  parallel   -- device meshes, GOP sharding, collectives
  cli        -- the five pipelines
"""

__version__ = "0.1.0"
