"""Tiles of the port's main path: synth and verify."""
