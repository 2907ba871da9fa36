"""Device time of the operations under no program span over all device
time of the traced window, in percent (``spans.py``): the spans'
coverage, which a change that moves work out of them raises."""
import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    return 100 * sp.self_s.get(spans.UNSPANNED, 0.0) / sp.total_s
