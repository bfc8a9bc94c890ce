"""Tile cores of the port's paths: synth and verify; shred (leader and
recover halves); replay; repair; tower and send."""
