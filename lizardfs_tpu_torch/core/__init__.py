"""ChunkEncoder boundary, slice geometry and goals, and read planning of the port."""
