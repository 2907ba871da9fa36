"""Device milliseconds a step of remat's recompute: every operation
launched under a program span inside the backward (``spans.py``'s
``:remat`` phase), the layer bodies' second forward."""
import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 1e3 * sp.phase_s(":remat") / run.steps
