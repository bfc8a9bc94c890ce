"""Tile cores of the port's paths: synth and verify; shred (leader and
recover halves); replay and its tower frames."""
