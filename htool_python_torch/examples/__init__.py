"""The reference's examples (example/use_*.py, example/advanced/*.py) on
the port.

Each runnable example puts its computation in `run(device=None,
partitions=2)`, which resolves the device as every entry point does (CUDA
unless the caller passes device='cpu'), makes the reference example's
assertions and returns the numbers it asserted on; it imports no
matplotlib.  Run as a script it also draws the reference example's
pictures:

    python -m htool_python_torch.examples.use_hmatrix [--cpu] [--show]
    python -m htool_python_torch.examples.advanced.use_custom_low_rank_approximation

The problems are the reference examples' own (sizes, epsilon, eta, leaf
sizes, seeds).  Operators are assembled in float32 and multiplied with
float32 vectors, the dtypes of the product kernel K1 on the card (the
reference's examples run in float32 on the TPU).  A float64 vector would
promote the product to float64, as the reference does on the CPU, and
run the float64 family's kernel instead.  The dense oracles, and the
user's own operators, stay in float64.
"""

# the runnable examples, as module names under this package
EXAMPLES = (
    "use_cluster",
    "use_hmatrix",
    "use_distributed_operator",
    "use_ddm_solver",
    "advanced.use_cluster_with_given_partition",
    "advanced.use_custom_dense_block_generator",
    "advanced.use_custom_global_to_local_operator",
    "advanced.use_custom_local_to_local_operator",
    "advanced.use_custom_low_rank_approximation",
    "advanced.use_local_hmatrix_compression",
)
