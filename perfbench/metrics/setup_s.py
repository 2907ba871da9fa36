"""Seconds from the process's start to the window's: imports, the card's
context, the kernels' load (their build on a checkout's first run), the
weights and batches drawn on the card, and the warm-up (a training
cell's first steps among it)."""


def read(run):
    return run.setup_s
