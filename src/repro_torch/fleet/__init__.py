"""repro_torch.fleet — data-aware fleet management for the cluster layer.

Closes the loop the paper's dynamic scheduler opens: the serving stack
already *measures* everything (per-stage times in every
``CompletionReport``), so host heterogeneity can be **learned** instead
of declared (``OnlineHostEstimator``), the offered-rate curve can be
**forecast** instead of chased (``ArrivalForecaster``), and capacity and
mode can move **ahead** of the diurnal peak (``PredictiveAutoscaler``).
All decisions are deterministic functions of the arrival/report streams
and are emitted as *derived* cluster events — recorded runs replay
byte-identically.
"""
from .autoscaler import PredictiveAutoscaler
from .estimator import HostEstimate, OnlineHostEstimator
from .forecast import ArrivalForecaster

__all__ = [
    "ArrivalForecaster",
    "HostEstimate",
    "OnlineHostEstimator",
    "PredictiveAutoscaler",
]
