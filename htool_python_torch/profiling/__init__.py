"""The kernel-profiling path: kernels P1-P4 and the cases that time them.

The port of the reference's kernel-profiling scripts (tools/
profile_matvec3.py, profile_matvec9c.py, profile_matvec5.py), which keep
their own Pallas kernels:

  * stream.py: P1 `stream_probe` (multi-buffer read rate) and P2
    `shape_stream` (read rate by buffer shape), csrc/stream_probe.cu;
  * bucket_variants.py: P3 `bucket_variant` (one bucket of K1's work under
    each gather x block math x y-accumulation) and P4 `take_along_axis`
    (the gather P3's 'take' uses), csrc/bucket_variants.cu;
  * timing.py: `chain_time` (the reference's `_chain_time`) and `cuda_ms`;
  * __main__.py: `python -m htool_python_torch.profiling [--cpu] [--out
    FILE]` runs the reference's case lists through them.

Nothing here imports JAX, the reference package or tools/.
"""
