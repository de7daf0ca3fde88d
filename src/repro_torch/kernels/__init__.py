"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

csrc/ holds the CUDA sources; agg_scan.py builds and binds them; ref.py is
the plain version of each; ops.py dispatches by device.
"""
