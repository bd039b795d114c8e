"""Snapshot sources for the port's drivers."""
