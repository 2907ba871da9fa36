"""Runtime: inter-operator pipeline execution (one CUDA stream per stage
group, event handover)."""
from .pipeline_exec import (GroupedPipelineExecutor, PipelineExecutor,
                            pipeline_round_count)
