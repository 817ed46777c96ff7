"""Integrators of the port: the path megakernel (slice K1a)."""
