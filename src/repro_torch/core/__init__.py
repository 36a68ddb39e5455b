"""Bit packing and bits-per-weight accounting shared by the port."""
