"""Batched LM serving (counterpart of `repro.serve`)."""
