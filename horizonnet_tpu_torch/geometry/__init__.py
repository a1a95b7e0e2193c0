"""Equirectangular geometry of the port."""
