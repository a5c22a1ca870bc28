"""Command-line entry points, flag-compatible with univst_tpu.cli."""
