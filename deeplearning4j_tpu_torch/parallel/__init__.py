"""Model and kernel modules of the port (counterpart of
`deeplearning4j_tpu.parallel`): the transformer, its hand-written
attention kernels, training steps, whole-sequence decoding, the
data-parallel plane — the device mesh, the partition vocabulary and
`DataParallelTrainer` — and the LM mesh trainers: ring attention
(`ring_attention`), the GPipe schedule (`pipeline`) and
`hybrid.HybridParallelTrainer` / `hybrid.PipelineParallelTrainer`."""

from deeplearning4j_tpu_torch.parallel.data_parallel import (
    DataParallelTrainer,
)
from deeplearning4j_tpu_torch.parallel.generation import beam_search, generate
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
from deeplearning4j_tpu_torch.parallel.partition import (
    PartitionSpec,
    gather_tree,
    replicated,
    reshard,
    shard_tree,
    sharded,
)

__all__ = ["make_mesh", "DataParallelTrainer", "generate", "beam_search",
           "PartitionSpec", "replicated", "sharded", "reshard",
           "shard_tree", "gather_tree"]
