"""Placement of the port's logical sample shards over a simulated process
fleet (counterpart of `repro.sharding`; the LM substrate's sharding rules
are not ported)."""
