"""Streaming refit: ring buffers, the streaming step and the session."""
