"""Fleet scale-out over ranks: ``torch.distributed`` in place of the JAX
package's device mesh and ``shard_map``."""
