"""The split LM: attention, Mamba and xLSTM layers, the decoder stack and its caches."""
