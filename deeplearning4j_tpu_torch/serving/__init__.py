"""Serving plane of the port (counterpart of `deeplearning4j_tpu.serving`):
the classifier `ServingEngine` behind the `MicroBatcher`
(`serving.engine`, `serving.batcher`), the thread-hosted replica fleet
behind the `FleetRouter` and its `FleetServer` front (`serving.fleet`),
the continuous LM server over a paged or dense KV cache, its page
allocator and radix prefix cache, the speculative drafters
(`serving.draft`), the KV page frame (`serving.transfer`), priorities,
the swap store and the brownout ladder (`serving.pressure`), the tiered
state store (`serving.hibernate`), tenancy (`serving.tenancy`), the
bucket ladder (`serving.bucketing`), metrics, typed failures and the
circuit breaker, and the process supervisor of worker fleets
(`serving.procfleet`)."""

from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.bucketing import (
    DEFAULT_BATCH_BUCKETS,
    BucketLadder,
    pow2_length_buckets,
)
from deeplearning4j_tpu_torch.serving.draft import (
    Drafter,
    ModelDrafter,
    NgramDrafter,
)
from deeplearning4j_tpu_torch.serving.engine import ServingEngine
from deeplearning4j_tpu_torch.serving.fleet import (
    FleetClientError,
    FleetRouter,
    FleetServer,
    ROLE_BOTH,
    ROLE_DECODE,
    ROLE_PREFILL,
    Replica,
    check_fleet_ledger,
    spawn_local_replica,
)
from deeplearning4j_tpu_torch.serving.hibernate import (
    DiskTier,
    TieredStateStore,
    prefix_key,
)
from deeplearning4j_tpu_torch.serving.lm import (
    ContinuousLMServer,
    validate_request,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.paged import (
    PageLeakError,
    PagePool,
    RadixPrefixCache,
)
from deeplearning4j_tpu_torch.serving.pressure import (
    PRIORITY_CLASSES,
    BrownoutLadder,
    PressureConfig,
    SwapEvictedError,
    SwapStore,
    normalize_priority,
)
from deeplearning4j_tpu_torch.serving.procfleet import (
    CrashLoopError,
    FleetSupervisor,
    RestartPolicy,
    WorkerSpec,
)
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    ServingError,
    ServingOverloadError,
    ServingUnavailableError,
    TenantQuotaError,
    UnservableShapeError,
    check_admission,
)
from deeplearning4j_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    FairQueueClock,
    SLOTracker,
    TenantRegistry,
    TenantSpec,
    TokenBucketMeter,
)
from deeplearning4j_tpu_torch.serving.transfer import (
    PageExport,
    PageShipError,
    check_compatible,
    deserialize_export,
    quantize_export,
    serialize_export,
)

__all__ = [
    "BrownoutLadder",
    "BucketLadder",
    "check_admission",
    "check_compatible",
    "check_fleet_ledger",
    "CircuitBreaker",
    "CircuitOpenError",
    "ContinuousLMServer",
    "CrashLoopError",
    "DeadlineExceededError",
    "DEFAULT_BATCH_BUCKETS",
    "DEFAULT_TENANT",
    "deserialize_export",
    "DiskTier",
    "Drafter",
    "FairQueueClock",
    "FleetClientError",
    "FleetRouter",
    "FleetServer",
    "FleetSupervisor",
    "MicroBatcher",
    "ModelDrafter",
    "NgramDrafter",
    "normalize_priority",
    "PageExport",
    "PageLeakError",
    "PagePool",
    "PageShipError",
    "pow2_length_buckets",
    "prefix_key",
    "PressureConfig",
    "PRIORITY_CLASSES",
    "quantize_export",
    "RadixPrefixCache",
    "Replica",
    "RestartPolicy",
    "ROLE_BOTH",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "serialize_export",
    "ServingEngine",
    "ServingError",
    "ServingMetrics",
    "ServingOverloadError",
    "ServingUnavailableError",
    "SLOTracker",
    "spawn_local_replica",
    "SwapEvictedError",
    "SwapStore",
    "TenantQuotaError",
    "TenantRegistry",
    "TenantSpec",
    "TieredStateStore",
    "TokenBucketMeter",
    "UnservableShapeError",
    "validate_request",
    "WorkerSpec",
]
