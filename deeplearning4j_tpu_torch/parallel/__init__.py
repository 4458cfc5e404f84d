"""Model and kernel modules of the port (counterpart of
`deeplearning4j_tpu.parallel`): the transformer, its hand-written
attention kernels, training steps and whole-sequence decoding.  The
JAX package's mesh names (`make_mesh`, `DataParallelTrainer`,
`PartitionSpec`, the sharding helpers) are multi-device work, ROADMAP.md
queue A7."""

from deeplearning4j_tpu_torch.parallel.generation import beam_search, generate

__all__ = ["generate", "beam_search"]
