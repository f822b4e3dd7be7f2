"""The CogVideoX PAB demo."""
