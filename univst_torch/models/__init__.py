"""Models: SD UNet, temporal-decoder VAE, CLIP text, weight carry-over."""
