"""Shared host-side utilities (streams, varints)."""
