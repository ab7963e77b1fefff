"""Utilities: JAX-parameter import, device selection, PNG writer."""
