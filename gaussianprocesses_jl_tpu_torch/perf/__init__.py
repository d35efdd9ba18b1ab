"""Kernel studies of the port, runnable on the card (`python -m ...`)."""
