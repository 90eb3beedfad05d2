"""The paper's own experiment (§IV) on the port: the harness the figure
benchmarks share."""
