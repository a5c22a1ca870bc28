"""Host-side I/O helpers."""
