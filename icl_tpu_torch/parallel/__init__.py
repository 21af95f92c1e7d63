"""Multi-process data parallelism (counterpart of `icl_tpu/parallel/`):
the data-parallel group (`mesh`), the explicit reductions that XLA inserts
in the JAX package (`collectives`), and the launch contract of the training
CLIs (`multihost`)."""
