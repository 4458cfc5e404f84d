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
circuit breaker."""

from deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from deeplearning4j_tpu_torch.serving.bucketing import (
    BucketLadder,
    pow2_length_buckets,
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
    TenantRegistry,
    TenantSpec,
)

__all__ = [
    "BucketLadder",
    "CircuitBreaker",
    "CircuitOpenError",
    "ContinuousLMServer",
    "DeadlineExceededError",
    "FleetClientError",
    "FleetRouter",
    "FleetServer",
    "MicroBatcher",
    "PageLeakError",
    "PagePool",
    "RadixPrefixCache",
    "ROLE_BOTH",
    "ROLE_DECODE",
    "ROLE_PREFILL",
    "Replica",
    "ServingEngine",
    "ServingError",
    "ServingMetrics",
    "ServingOverloadError",
    "ServingUnavailableError",
    "TenantQuotaError",
    "TenantRegistry",
    "TenantSpec",
    "UnservableShapeError",
    "check_admission",
    "check_fleet_ledger",
    "pow2_length_buckets",
    "spawn_local_replica",
    "validate_request",
]
