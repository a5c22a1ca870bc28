"""Attention ops and the sparse-causal video flash attention kernel."""
