"""The yardstick of the roofline shares: the H100's peaks and, one file
per kernel family, the operations and bytes a call needs, counted from
its shape (copied from ``chip_smoke.py``'s counts and frozen here)."""
