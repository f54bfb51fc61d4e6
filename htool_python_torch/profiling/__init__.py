"""The kernel-profiling path: kernels P1-P4 and the cases that time them.

The port of the reference's kernel-profiling scripts (tools/
profile_matvec3.py, profile_matvec9c.py, profile_matvec5.py), which keep
their own Pallas kernels:

  * stream.py: P1 `stream_probe` (multi-buffer read rate) and P2
    `shape_stream` (read rate by buffer shape), csrc/stream_probe.cu;
  * bucket_variants.py: P3 `bucket_variant` (one bucket of K1's work under
    each gather x block math x y-accumulation) and P4 `take_along_axis`
    (the gather P3's 'take' uses), csrc/bucket_variants.cu;
  * timing.py: `chain_time` (the reference's `_chain_time`), `cuda_ms`
    and `device_ms`;
  * bounds.py: a product's bound (`product_bound`) and P1's best read
    rate in the current run (`p1_best_gbs`);
  * __main__.py: `python -m htool_python_torch.profiling [--cpu] [--out
    FILE]` runs the reference's case lists through them.

And the port of the reference's K1 attribution scripts (tools/
profile_matvec9.py, 9b, 9d, 9e, 9f, 9g), which time K1 itself:

  * k1_sweeps.py: `python -m htool_python_torch.profiling.k1_sweeps
    [--cpu] [--ks 1,8,128] [--out FILE]`, K1 by block shape, width,
    offset structure and padding rule.

Beside them, design variants of the hand-written kernels, each rebuilt
from its source with one choice changed: k1_variants.py (K1 / K2),
xgemm_variants.py (P3's 'xgemm'), f64_variants.py (the f64 family).

Nothing here imports JAX, the reference package or tools/.
"""
