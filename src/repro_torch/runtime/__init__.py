"""Runtime: inter-operator pipeline execution (one CUDA stream per stage
group, event handover, on one card or over a mesh's slots), the
ExecutionBackend protocol that decouples schedules from execution
substrates, straggler mitigation, elastic rescaling."""
from .pipeline_exec import (GroupedPipelineExecutor, PipelineExecutor,
                            pipeline_round_count)
from .backend import (AnalyticBackend, BackendFuture, ClusterBackend,
                      CompletionReport, ExecutionBackend, PipelineHandle,
                      ReplayBackend, StageChain,
                      TorchPipelineBackend, TraceRecorder, WorkerLost, make_backend, pipeline_fill)
from .straggler import (ProbationTracker, StragglerMonitor,
                        WallClockCalibrator)
from .elastic import ElasticRuntime, PoolState
