"""Checkpointing: async save, atomic commit, restart discovery."""
from .ckpt import (Checkpointer, latest_step, save_pytree, restore_pytree)
