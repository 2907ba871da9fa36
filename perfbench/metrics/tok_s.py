"""Tokens of every pass or train step of the window (a prefill pass's
prompt tokens; a train step's tokens, the optimizer included) over the
window's wall time (host clock; the window ends in a synchronise)."""


def read(run):
    return run.tokens / run.window_s
