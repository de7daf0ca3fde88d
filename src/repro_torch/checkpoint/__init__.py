"""Checkpoints of the LM substrate (counterpart of `repro.checkpoint`)."""
