"""Observability of the port (counterpart of `repro.obs`): the clocks."""
