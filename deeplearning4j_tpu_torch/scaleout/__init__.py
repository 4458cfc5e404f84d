"""Distributed training control plane (counterpart of
`deeplearning4j_tpu.scaleout`).

Parity: reference "scaleout" tier (SURVEY §2.3), the CONTROL PLANE the
reference built on Hazelcast IMaps + actors:

- job queue / routing          (`WorkRouter`, reference workrouter/*)
- worker registry + heartbeats (`StateTracker`, reference statetracker/*)
- stale-worker reaping         (reference MasterActor.java:141-160, ≥120s)
- update aggregation           (`JobAggregator`, reference INDArrayAggregator)
- work persistence / elastic rejoin (reference LocalWorkRetriever/
  LocalFileUpdateSaver)
- periodic model saving        (reference ModelSavingActor)

An in-process simulator (`DistributedRunner.simulate`) mirrors the
reference's three "distributed without a cluster" test backends (SURVEY §4):
master + N workers as threads against one tracker.  Across hosts the same
`StateTracker` API is served over TCP (tracker_server.py), in the JAX
package's wire format.  The performers train port models on the card
(`NetworkPerformer`; the char-LSTM's forward is the hand-written LSTM
kernel) and exchange host numpy trees through the tracker.
"""

from deeplearning4j_tpu_torch.scaleout.api import (
    Job,
    JobAggregator,
    JobIterator,
    WorkerPerformer,
    WorkRouter,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import StateTracker
from deeplearning4j_tpu_torch.scaleout.tracker_server import (
    RemoteStateTracker,
    StateTrackerServer,
)
from deeplearning4j_tpu_torch.scaleout.aggregators import (
    DeltaSumAggregator,
    ParameterAveragingAggregator,
)
from deeplearning4j_tpu_torch.scaleout.performers import (
    GlovePerformer,
    NetworkPerformer,
    Word2VecPerformer,
)
from deeplearning4j_tpu_torch.scaleout.runner import (
    DistributedRunner,
    HogwildWorkRouter,
    IterativeReduceWorkRouter,
    Master,
    Worker,
)

__all__ = [
    "Job", "JobIterator", "WorkerPerformer", "JobAggregator", "WorkRouter",
    "StateTracker", "RemoteStateTracker", "StateTrackerServer",
    "ParameterAveragingAggregator", "DeltaSumAggregator",
    "NetworkPerformer", "Word2VecPerformer", "GlovePerformer",
    "Master", "Worker", "DistributedRunner",
    "IterativeReduceWorkRouter", "HogwildWorkRouter",
]
