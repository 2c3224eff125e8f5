"""Core tensor-network layer: padded MPS, gates, truncation, observables."""
