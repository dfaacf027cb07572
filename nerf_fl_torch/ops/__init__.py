"""Hand-written Hopper kernels with their plain PyTorch versions, and the
torch forms of the JAX package's sort/gather workarounds."""
from .sorting import rank_merge_sorted, sorted_uniform  # noqa: F401
