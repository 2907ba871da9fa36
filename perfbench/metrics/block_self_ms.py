"""Device milliseconds a pass or step in the self time of the span
``rt.block`` (a layer body outside its mixer's spans: the Mamba2 block's
pre-norm and residual add, ``models/lm.py:mamba_block``), forward, remat
and backward together (``spans.py``)."""
import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 1e3 * sp.seconds("rt.block") / run.steps
