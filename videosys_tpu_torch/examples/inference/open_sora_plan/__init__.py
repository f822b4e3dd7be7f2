"""Open-Sora-Plan inference sample."""
