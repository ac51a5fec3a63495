"""Chunk striping helpers of the port."""
