"""Serving plane of the port (counterpart of `deeplearning4j_tpu.serving`):
the continuous LM server over a paged or dense KV cache, its page
allocator and radix prefix cache, the speculative drafters
(`serving.draft`), the KV page frame (`serving.transfer`), priorities,
the swap store and the brownout ladder (`serving.pressure`), the tiered
state store (`serving.hibernate`), the bucket ladder
(`serving.bucketing`), metrics and typed failures."""

from deeplearning4j_tpu_torch.serving.bucketing import (
    BucketLadder,
    pow2_length_buckets,
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
    DeadlineExceededError,
    ServingError,
    ServingOverloadError,
    ServingUnavailableError,
    check_admission,
)

__all__ = [
    "BucketLadder",
    "ContinuousLMServer",
    "DeadlineExceededError",
    "PageLeakError",
    "PagePool",
    "RadixPrefixCache",
    "ServingError",
    "ServingMetrics",
    "ServingOverloadError",
    "ServingUnavailableError",
    "check_admission",
    "pow2_length_buckets",
    "validate_request",
]
