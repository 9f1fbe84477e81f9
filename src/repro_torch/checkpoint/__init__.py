"""Fault-tolerant checkpointing of the port: atomic, async, in the
reference's on-disk layout."""

from .checkpointer import Checkpointer, latest_step, restore, save

__all__ = ["Checkpointer", "latest_step", "restore", "save"]
