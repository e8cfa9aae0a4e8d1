"""The sharded paths (counterpart of ``glass_tpu/parallel``): the process
mesh, the graph partition, and the sharded trainers."""

from glass_tpu_torch.parallel.mesh import make_mesh
from glass_tpu_torch.parallel.partition import partition_graph, PartitionedGraph
from glass_tpu_torch.parallel.train import ShardedTrainer
from glass_tpu_torch.parallel.auto import AutoTrainer
