"""One-shot and streaming generation."""
