"""The port's kernels: hand-written Hopper kernels, each beside its plain
PyTorch version, chosen by ``runtime.use_kernel`` from the tensor's device."""
