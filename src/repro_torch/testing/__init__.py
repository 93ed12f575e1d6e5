"""Shared inputs for the checks of the port's kernels on the card."""
