"""DYPE core — the paper's primary contribution (the port's own copy).

Workload description, device/system specs, kernel performance models (§V),
communication (§II-B/§III) and energy models, the DP scheduler (Algorithm 1)
with Pareto endpoint sweep and perf/energy/balanced modes, baselines (§VI-A),
and the dynamic data-aware rescheduler.
"""
from .workload import (KernelSpec, Workload, GraphDataset, DATASETS,
                       gcn_workload, gin_workload, swa_transformer_workload)
from .device import (DeviceType, HostProfile, Interconnect, SystemSpec,
                     H100_DENSE, H100_SPARSE, INTERCONNECTS, MI210, U280,
                     UNIFORM_HOST, h100_system, paper_system,
                     relative_profile)
from .perf_model import PerfModel, fit_models, LinearModel
from .comm_model import transfer_time, effective_bw, p2p_speedup
from .energy_model import pipeline_energy, energy_efficiency, stage_energy
from .scheduler import (Scheduler, Stage, Pipeline, ScheduleResult,
                        apply_profile, evaluate_assignment, result_of,
                        static_bytes)
from .baselines import (gpu_only, fpga_only, theoretical_additive,
                        static_schedule, fleetrec, preferred_type)
from .dynamic import DynamicScheduler, RescheduleEvent, signature
from . import hw_oracle
