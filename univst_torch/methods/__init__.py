"""Method loops: DDIM inversion, stylization, mask propagation."""
