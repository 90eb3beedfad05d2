"""The split LM: attention layers, the decoder stack and its caches."""
