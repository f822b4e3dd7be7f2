"""CogVideoX inference sample."""
