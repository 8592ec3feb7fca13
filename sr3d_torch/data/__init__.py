"""Synthetic face data for the train steps."""
