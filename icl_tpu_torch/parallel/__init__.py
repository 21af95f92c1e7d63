"""Multi-process data and tensor parallelism (counterpart of
`icl_tpu/parallel/`): the (data, model) grid of processes, its groups and
the rules that shard the weights over its model axis (`mesh`), Megatron's
collectives and parallel layers over the model group (`tensor`), the
explicit reductions over the data group that XLA inserts in the JAX
package (`collectives`), and the launch contract of the training CLIs
(`multihost`)."""
