"""Checkpointing: async save, atomic commit, restart discovery, on one
device or on a mesh."""
from .ckpt import (Checkpointer, gathered_leaves, latest_step, restore_pytree,
                   save_pytree)
