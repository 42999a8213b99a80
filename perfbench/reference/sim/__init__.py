"""Frozen copy of the simulator (town, agents, collisions, dynamics, step, reset)."""
