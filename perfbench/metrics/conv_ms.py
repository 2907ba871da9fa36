"""Device milliseconds a pass or step under the span ``rt.ssm.conv``
(``models/ssm.py``: the split of in_proj's output and the causal conv
with its bias and silu), forward, remat and backward together
(``spans.py``)."""
import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 1e3 * sp.seconds("rt.ssm.conv", inclusive=True) / run.steps
