"""Serving: the bucketed, pipelined inference engine, the SLO scheduler,
the session carries, the HTTP flow service, the streaming engine and the
fleet router over N replicas.

Counterpart of ``dexiraft_tpu/serve``. serve_cli builds the model and
steps; these modules take them as callables, so they run on numpy stubs
without a model. The router needs no model and no device at all.
"""

from dexiraft_tpu_torch.serve.buckets import BucketRegistry, bucket_shape
from dexiraft_tpu_torch.serve.engine import (InferenceEngine, Result,
                                             ServeConfig, add_engine_args)
from dexiraft_tpu_torch.serve.router import (HashRing, NoHealthyReplica,
                                             ReplicaPool, Router,
                                             RouterConfig)
from dexiraft_tpu_torch.serve.scheduler import (QueueFull, Scheduler,
                                                SchedulerClosed,
                                                SchedulerStats)
from dexiraft_tpu_torch.serve.server import FlowService
from dexiraft_tpu_torch.serve.sessions import DeviceSessionStore, SessionStore
from dexiraft_tpu_torch.serve.video import ChunkResult, VideoEngine

__all__ = [
    "FlowService",
    "HashRing",
    "NoHealthyReplica",
    "ReplicaPool",
    "Router",
    "RouterConfig",
    "BucketRegistry",
    "bucket_shape",
    "InferenceEngine",
    "Result",
    "ServeConfig",
    "add_engine_args",
    "QueueFull",
    "Scheduler",
    "SchedulerClosed",
    "SchedulerStats",
    "SessionStore",
    "DeviceSessionStore",
    "VideoEngine",
    "ChunkResult",
]
