"""Chunk striping and test-data helpers of the port."""
