"""Open-Sora v1.2 inference sample."""
