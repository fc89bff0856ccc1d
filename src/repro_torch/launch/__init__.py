"""Command-line drivers of the port (serving, training, the dry run) and the
launch analysis of one H100: each step counted on fake tensors and bounded."""
