from .manager import CheckpointManager, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "restore_pytree", "save_pytree"]
