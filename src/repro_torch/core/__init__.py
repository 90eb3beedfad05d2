"""The COMtune link at the split point: compression, loss masks, channel
emulation and the link accounting of the DI round."""
