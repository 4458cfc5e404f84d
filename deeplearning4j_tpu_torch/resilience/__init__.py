"""Resilience of the port (counterpart of `deeplearning4j_tpu.resilience`):
the training supervisor and its fault-tolerance substrate.

- `retry` — shared exponential-backoff-with-jitter policy (the
  supervisor's batch-fetch path).
- `health` — per-step loss/grad-norm finiteness and divergence monitor
  (loss > K x rolling median) that recommends skip/rollback actions.
- `watchdog` — times out hung device steps and surfaces a structured
  `FaultReport` instead of wedging the job.
- `supervisor` — `TrainingSupervisor`: wraps a `MultiLayerNetwork` with
  poison-batch skipping, divergence rollback to the last good checkpoint
  with LR backoff, a checkpoint policy (every-N + keep-last-K +
  best-score retention), and SIGTERM/preemption handling that flushes an
  emergency checkpoint.
- `chaos` — deterministic fault injection for every recovery path, the
  training, checkpoint, serving, fleet and process ones.
"""

from deeplearning4j_tpu_torch.resilience.chaos import (
    ChaosConfig,
    ChaosDataSource,
    CheckpointChaosConfig,
    FleetChaosConfig,
    InjectedCheckpointCrash,
    InjectedDispatchFault,
    ProcessChaosConfig,
    ServingChaosConfig,
    TenantChaosConfig,
    chaos_checkpoint,
    chaos_dispatch,
    chaos_fleet,
    chaos_procfleet,
    chaos_runner,
    chaos_tenant,
    corrupt_checkpoint,
    flip_byte,
    truncate_file,
)
from deeplearning4j_tpu_torch.resilience.faults import (
    FaultReport,
    PreemptedError,
    SimulatedPreemption,
    StepTimeoutError,
    SupervisorAbort,
)
from deeplearning4j_tpu_torch.resilience.health import HealthAction, HealthMonitor
from deeplearning4j_tpu_torch.resilience.retry import (
    RetryPolicy,
    backoff_delays,
    retry_call,
)
from deeplearning4j_tpu_torch.resilience.supervisor import (
    ResilienceConfig,
    RunReport,
    TrainingSupervisor,
)
from deeplearning4j_tpu_torch.resilience.watchdog import StepWatchdog

__all__ = [
    "ChaosConfig",
    "ChaosDataSource",
    "CheckpointChaosConfig",
    "FleetChaosConfig",
    "InjectedCheckpointCrash",
    "InjectedDispatchFault",
    "ProcessChaosConfig",
    "ServingChaosConfig",
    "TenantChaosConfig",
    "chaos_checkpoint",
    "chaos_dispatch",
    "chaos_fleet",
    "chaos_procfleet",
    "chaos_runner",
    "chaos_tenant",
    "corrupt_checkpoint",
    "flip_byte",
    "truncate_file",
    "FaultReport",
    "PreemptedError",
    "SimulatedPreemption",
    "StepTimeoutError",
    "SupervisorAbort",
    "HealthAction",
    "HealthMonitor",
    "RetryPolicy",
    "backoff_delays",
    "retry_call",
    "ResilienceConfig",
    "RunReport",
    "TrainingSupervisor",
    "StepWatchdog",
]
