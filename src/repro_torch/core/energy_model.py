"""Energy model (paper §II-A, Table II).

f_eng: energy of one pipeline iteration (one inference traversing all stages
while the pipeline is in steady state). Per stage of period T (the longest
stage time — the initiation interval):

    E_stage = n_dev * [ P_dyn(kind) * t_exec
                        + P_transfer * t_comm
                        + P_static  * T ]

i.e. dynamic power while executing, transfer power while communicating, and
static (idle-floor) power for the whole period — stage idleness (T - busy)
burns static power only. Devices not allocated to any stage are powered off
(the endpoint sweep in the scheduler compares different device counts).

Units (shared by every consumer, including ``repro.energy``):

  * times (``t_exec``, ``t_comm``, ``period``) are **seconds** on the
    simulated clock;
  * device powers (``dynamic``, ``transfer_power``, ``static_power``)
    are **watts**;
  * ``stage_energy`` / ``pipeline_energy`` are therefore **joules per
    inference** (one steady-state pipeline iteration);
  * ``energy_efficiency`` is **inferences per joule**;
  * ``pipeline_power`` is **watts at steady state** — joules/inference
    divided by the initiation interval (seconds/inference). It is the
    sustained electrical draw of the pipeline while it is kept busy,
    the quantity a fleet power cap constrains.
"""
from __future__ import annotations


def stage_energy(stage, period: float) -> float:
    dev = stage.dev
    e_dyn = sum(dev.dynamic(kind) * t for kind, t in stage.exec_parts)
    e_comm = dev.transfer_power * (stage.t_in + stage.t_out)
    e_static = dev.static_power * period
    return stage.n * (e_dyn + e_comm + e_static)


def pipeline_energy(stages, period: float) -> float:
    """f_eng: joules per inference in steady state."""
    return sum(stage_energy(s, period) for s in stages)


def energy_efficiency(stages, period: float) -> float:
    """Inferences per joule (the paper's energy-efficiency metric).
    A degenerate non-positive energy (empty pipeline, or a defensive
    guard against model underflow) maps to ``inf`` rather than raising
    or going negative — callers rank by it, they never invert it."""
    e = pipeline_energy(stages, period)
    return 1.0 / e if e > 0 else float("inf")


def pipeline_power(stages, period: float) -> float:
    """Watts at steady state: joules/inference over seconds/inference.
    Zero for a degenerate pipeline (no stages or non-positive period) —
    an unscheduled cell draws nothing, it cannot draw negative power."""
    if period <= 0:
        return 0.0
    return max(0.0, pipeline_energy(stages, period)) / period
