"""The model FLOPs of the traced window's passes or steps
(``counts.step_flops``) over the window's seconds at the card's dense bf16
peak, in percent."""
import counts


def read(run):
    if run.trace is None:
        return None
    flops = counts.step_flops(run.cell.as_run, run.cell.mix) * run.steps
    return 100 * flops / (run.trace.window_s * counts.BF16_FLOP_S)
