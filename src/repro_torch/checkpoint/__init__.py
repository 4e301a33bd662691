"""repro_torch.checkpoint — tree checkpoints in the reference's on-disk
format (see io.py)."""
from .io import (LeafSpec, latest_step, leaf_keys, load_checkpoint,
                 restore, save_checkpoint, tree_flatten_with_path,
                 tree_unflatten)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "restore",
           "LeafSpec", "leaf_keys", "tree_flatten_with_path", "tree_unflatten"]
