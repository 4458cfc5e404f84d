"""Fault injection of the port (counterpart of
`deeplearning4j_tpu.resilience`): the serving and fleet faults of
`chaos`.  The training supervisor, health checks, retries, the watchdog
and the other fault kinds are not ported (ROADMAP.md, A6 and A7)."""

from deeplearning4j_tpu_torch.resilience.chaos import (
    FleetChaosConfig,
    InjectedDispatchFault,
    ServingChaosConfig,
    chaos_dispatch,
    chaos_fleet,
)

__all__ = ["FleetChaosConfig", "InjectedDispatchFault", "ServingChaosConfig",
           "chaos_dispatch", "chaos_fleet"]
