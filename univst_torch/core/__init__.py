"""Core math: DDIM schedule, AdaIN, configs, trajectory store."""
