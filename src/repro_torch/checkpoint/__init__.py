"""Checkpointing of the port, in the JAX package's on-disk format."""
from repro_torch.checkpoint.checkpointer import Checkpointer
