"""The SSD work's least time at the cell's shapes (``counts.ssd_least_s``:
a forward call a mamba layer, in training a backward call too) over the
device time of every kernel with ``ssd`` in its name, in percent. A run
whose SSD entry counted calls while the trace shows no such kernel
fails: a renamed kernel shows as a fault, never as a 0 or a gain."""
import counts
import devtrace


def read(run):
    if run.trace is None or not run.launches.get("ssd.ssd_chunked"):
        return None
    spent = run.trace.seconds(devtrace.is_ssd)
    if spent <= 0:
        raise RuntimeError("the SSD entry counted calls but the trace "
                           "shows no kernel with 'ssd' in its name")
    return 100 * counts.ssd_least_s(run.cell.as_run, run.cell.mix) \
        * run.steps / spent
