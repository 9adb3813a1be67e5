"""Data parallelism over torch.distributed: one process per card (the port
of crct_tpu/parallel, whose mesh spans a host's chips; see mesh.py)."""

from crct_tpu_torch.parallel.mesh import (allreduce_gradients, allreduce_sum,
                                          any_rank, broadcast_module,
                                          destroy, global_sum,
                                          init_distributed,
                                          maybe_initialize_distributed, rank,
                                          rank_seed, shard, world_size)
