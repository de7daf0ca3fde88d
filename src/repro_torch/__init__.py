"""BlinkDB on PyTorch and CUDA: the port of the `repro` package to one
NVIDIA H100.

The package mirrors `repro`'s layout (core/, data/, kernels/) and holds
each ported module against its JAX counterpart in the tests. It imports
torch and numpy only: never jax, never `repro`. Entry points run on the
card (`device="cuda"`) unless the caller asks for the CPU.
"""
