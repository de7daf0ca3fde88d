"""Placement of the port's logical sample shards over a simulated process
fleet (`placement`, counterpart of `repro.sharding.placement`), and the
LM substrate's logical-axis sharding rules (`rules`, counterpart of
`repro.sharding.rules`) with the LM on a mesh of ranks (`lm`)."""
