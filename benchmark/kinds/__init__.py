"""Traffic kinds, one file a kind, found by a traffic file's ``"kind"``.

Each defines ``input_set(traffic, latent_channels, gen, device) -> dict``:
one job's inputs drawn from ``gen`` (a seeded ``torch.Generator`` on
``device``) by the traffic file's parameters.
"""
