"""repro_torch.energy: continuous Pareto-frontier serving.

``frontier`` materializes the DP scheduler's Pareto front into ordered
operating points; ``governor`` walks that frontier against the arrival
forecast each control tick; ``budget`` caps the fleet's modeled power
draw and steers placement by watts headroom. See ``docs/energy.md``.

Every watt and joule here comes from the DyPe energy model of the
scheduled system (``core/energy_model.py``, the paper's FPGA + GPU
fleet), on the simulated clock; none is read from the card the torch
backend runs on.
"""
from .budget import PowerBudget
from .frontier import FrontierCache, OperatingPoint, materialize, quantize_frac
from .governor import ParetoGovernor

__all__ = [
    "FrontierCache",
    "OperatingPoint",
    "ParetoGovernor",
    "PowerBudget",
    "materialize",
    "quantize_frac",
]
