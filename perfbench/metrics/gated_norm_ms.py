"""Device milliseconds a pass or step under the span
``rt.ssm.gated_norm`` (``models/ssm.py:_gated_norm``: y times silu(z)
and the RMS norm over d_inner), forward, remat and backward together
(``spans.py``)."""
import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 1e3 * sp.seconds("rt.ssm.gated_norm", inclusive=True) / run.steps
