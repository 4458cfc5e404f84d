"""Runtime services of the port (counterpart of
`deeplearning4j_tpu.runtime`): checkpoints and model files, the fused
training driver, remote stores, determinism checks, the profiler, model
import and the process launcher."""

from deeplearning4j_tpu_torch.runtime.checkpoint import (
    AsyncCheckpointListener,
    CheckpointCorruptError,
    CheckpointListener,
    DiskModelSaver,
    ModelSaver,
    best_checkpoint,
    latest_checkpoint,
    load_checkpoint,
    load_model,
    load_params,
    read_ckpt_manifest,
    read_manifest,
    rebuild_manifest,
    resume_train_state,
    save_checkpoint,
    save_model,
    save_params,
    sweep_orphans,
    verify_checkpoint,
)
from deeplearning4j_tpu_torch.runtime.determinism import (
    NondeterminismError,
    check_network_determinism,
    check_step_determinism,
)
from deeplearning4j_tpu_torch.runtime.fused import (
    FusedTrainingDriver,
    HostChunk,
    assemble_chunks,
)
from deeplearning4j_tpu_torch.runtime.storage import (
    RemoteModelSaver,
    get_store,
    load_checkpoint_remote,
    load_model_remote,
    remote_dataset,
    save_checkpoint_remote,
)

__all__ = [
    "FusedTrainingDriver",
    "HostChunk",
    "assemble_chunks",
    "save_model",
    "load_model",
    "save_params",
    "load_params",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "best_checkpoint",
    "read_manifest",
    "read_ckpt_manifest",
    "rebuild_manifest",
    "resume_train_state",
    "verify_checkpoint",
    "sweep_orphans",
    "CheckpointCorruptError",
    "ModelSaver",
    "DiskModelSaver",
    "AsyncCheckpointListener",
    "CheckpointListener",
    "get_store",
    "save_checkpoint_remote",
    "load_checkpoint_remote",
    "RemoteModelSaver",
    "load_model_remote",
    "remote_dataset",
    "check_step_determinism",
    "check_network_determinism",
    "NondeterminismError",
]
