"""Data semantics shared by the closed loop (action labels)."""
