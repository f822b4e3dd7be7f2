"""Latte inference sample."""
