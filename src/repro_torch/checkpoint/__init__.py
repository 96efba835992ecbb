"""Checkpoints in the JAX package's msgpack format (`repro.checkpoint`)."""
from repro_torch.checkpoint.ckpt import (load_checkpoint, packb, read_tree,
                                         save_checkpoint, unpackb)

__all__ = ["load_checkpoint", "packb", "read_tree", "save_checkpoint",
           "unpackb"]
