"""repro_torch.cluster — multi-host control plane for the serving stack.

Scale-out beyond one host behind the same ``ExecutionBackend`` protocol
the Router/Engine already speak:

    Router/Engine ──> ClusterBackend ──> Controller ──┬──> Worker w0
      (unchanged        (prepare/submit   (placement,  │    (sub-pool,
       scheduling        routed to the     heartbeats, │     local backend:
       code)             owning worker)    event log)  └──> Worker w1 ...

``comms`` provides the Channel transports (deterministic in-process, and
real multiprocessing — drivable under the Controller via
``add_remote_worker``); ``worker`` the transport-agnostic worker peer;
``controller`` the registry + host-aware placement (``HostProfile``
effective-throughput weighting, per-host DP re-solve via ``HostPlanner``)
+ work stealing + heartbeat failure detector + ``LocalCluster`` builder;
``events`` the recordable/replayable cluster-event JSONL (mirroring
``TrafficSim.to_jsonl``). A lost worker converts into per-pool
``on_failure`` events on the attached Router/ElasticRuntime and its
in-flight batches re-queue — the kill-mid-stream scenario is a
deterministic, replayable test case, and so is a steal-heavy run on a
heterogeneous fleet (steal events are derived, re-derived identically on
replay). See ``docs/cluster.md`` and ``docs/heterogeneity.md``.
"""
from .comms import (Channel, ChannelClosed, InProcChannel, MpChannel,
                    inproc_pair, mp_worker)
from .events import INPUT_KINDS, ClusterEvent, ClusterEventLog
from .worker import InProcPeer, WorkerCore, worker_main
from .controller import (Controller, HostPlanner, LocalCluster, WorkerLink,
                         split_pool)

__all__ = [
    "Channel", "ChannelClosed", "InProcChannel", "MpChannel",
    "inproc_pair", "mp_worker",
    "INPUT_KINDS", "ClusterEvent", "ClusterEventLog",
    "InProcPeer", "WorkerCore", "worker_main",
    "Controller", "HostPlanner", "LocalCluster", "WorkerLink", "split_pool",
]
