"""Vchitect-2.0 inference sample."""
