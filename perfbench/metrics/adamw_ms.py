"""Device milliseconds a step under the span ``rt.train.adamw``
(``launch/steps.py``: the schedule and ``optim/adamw.py:adamw_update``,
the clip's norm ``rt.adamw.norm`` included; ``spans.py``)."""
import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 1e3 * sp.seconds("rt.train.adamw", inclusive=True) / run.steps
