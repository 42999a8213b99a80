"""Frozen copy of the scene assembly and the camera projection."""
