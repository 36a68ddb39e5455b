"""Bit packing, bits-per-weight accounting and the param-tree layout
shared by the port."""
